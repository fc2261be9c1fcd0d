"""The multi-device layer (port of `nasrec_tpu/parallel/`): host-RAM table
offload (host_embedding.py), torch.distributed bring-up and sharded
checkpoints (distributed.py), and the (data, model) process mesh
(mesh.py) with its sharded lookup (embedding.py), state placement and
eval step (train.py).  The train steps take the mesh themselves
(`train/loop.py :: make_train_step`, `train/sparse_embedding.py ::
make_sparse_embedding_train_step`); train.py and sparse.py keep the JAX
package's names for them.  Import the submodules: the steps import the
mesh, so this package imports none of them."""
