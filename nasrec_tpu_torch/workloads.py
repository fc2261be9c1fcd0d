"""The four workloads as library functions (port of `nasrec_tpu/workloads.py`):
fixed-subnet training, supernet training, the weight-shared search over a
trained supernet, and the subnet-from-scratch evaluation; and, beside them,
DLRM-DCNv2's training on synthetic multi-hot batches (`train_dcnv2`).

Ported: data from TSV shards (the C++ parser, a prefetch thread and a copy to
the card on a side stream, data/pipeline.py) or synthetic; the
sparse-embedding step (Adagrad with wd = 0, micro-batches, any optimizer for
the other parameters with sparse_embedding=True) and the dense-gradient step
(SGD, Adam, or Adagrad with wd > 0), each on one device, in float32 or
bfloat16 compute (`compute_dtype`: the model's activations in bf16, the
parameters, table, optimizer state and logits in f32); supernet training
with every path-sampling strategy, resume from a checkpoint (any optimizer's
state), evo-2shot candidates, a pretrained table and both eval paths; random
search, regularized evolution and the re-scoring of a given candidate list,
in the three fine-tune modes, with the latency criterion (its latency
measured through the kernels or estimated by the cost model of
`profiling.py`); checkpoints (pickle, in the JAX package's layout, so each
package loads the other's) and `metrics.jsonl`; `report_flops` (a FLOPs and
parameters line, and the model's graph as text), `profile_dir` (a
torch.profiler trace) and `attention_impl` (kernels or plain versions for the
dot-product and transformer nodes).  The multi-device branches, as in the
JAX package: `mesh_model > 0` trains over a (data, model) mesh of processes
(parallel/: the table row-sharded over the model ranks, the batch over the
data ranks, the sparse or the dense step), which several processes need;
`place_embedding_on_cpu` keeps the table and its accumulator in host RAM
(parallel/host_embedding.py); `ckpt_backend="orbax"` writes a directory
checkpoint (train/checkpoint.py).  Under several processes only rank 0
writes files, and the search fans its candidate groups out across the
ranks.  The refusals are the JAX package's, with its reasons
(`_validate_train_options`).  The search, as in the JAX package, runs in
float32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from nasrec_tpu_torch import profiling
from nasrec_tpu_torch.choices import Choice, choice_to_masks, full_path_choice
from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
from nasrec_tpu_torch.data.pipeline import device_prefetch, make_dataset_iterators
from nasrec_tpu_torch.data.synthetic import SyntheticSpec, multihot_batches, synthetic_batches
from nasrec_tpu_torch.device import resolve_device
from nasrec_tpu_torch.models.dcn import DCNv2Config, dcnv2_init
from nasrec_tpu_torch.models.embedding import load_embedding_from_checkpoint, table_offsets
from nasrec_tpu_torch.models.fixed import build_fixed_plan, fixed_apply, fixed_init
from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
from nasrec_tpu_torch.models.transplant import (
    from_jax_opt_state,
    from_jax_params,
    to_jax_opt_state,
    to_jax_params,
)
from nasrec_tpu_torch.parallel.distributed import host_info
from nasrec_tpu_torch.parallel.host_embedding import (
    HostEmbedding,
    detach_table,
    make_host_offload_eval_step,
    make_host_offload_train_step,
)
from nasrec_tpu_torch.parallel.mesh import make_mesh
from nasrec_tpu_torch.parallel.train import make_sharded_eval_step, shard_train_state
from nasrec_tpu_torch.sampling import ChoiceSampler, DeviceMaskBuffer
from nasrec_tpu_torch.search import SearchConfig, Searcher, Tokenizer, make_candidate_evaluator
from nasrec_tpu_torch.train.checkpoint import (
    as_opt_state,
    load_any_checkpoint,
    save_checkpoint_any,
)
from nasrec_tpu_torch.train.logging import MetricsWriter
from nasrec_tpu_torch.train.loop import (
    TABLE,
    init_train_state,
    make_eval_step,
    make_train_step,
    train_and_test_one_epoch,
)
from nasrec_tpu_torch.train.optim import (
    copy_state_,
    make_lr_schedule,
    make_optimizer,
    slot_dicts,
)
from nasrec_tpu_torch.train.sparse_embedding import (
    init_sparse_train_state,
    make_sparse_embedding_train_step,
)


@dataclasses.dataclass
class DataOptions:
    dataset: str = "criteo-kaggle"
    root_dir: str = ""                # TSV root: shard-*/{train,val,test,trainval}.txt
    data_source: str = "tsv"          # tsv | synthetic
    train_split: str = "trainval"
    validate_split: str = "test"
    train_batch_size: int = 256
    test_batch_size: int = 16368
    vocab_cap: Optional[int] = None   # SEARCH_MAX_NUM_EMBEDDINGS during search (TSV)
    synthetic_train_examples: int = 65536
    synthetic_test_examples: int = 8192
    # Per-slot table size for synthetic data; must cover the synthetic index
    # range (an out-of-range index would land in the next slot's rows).
    synthetic_vocab: int = 1000
    # This process reads the shards where shard_idx % num_hosts == host_id.
    host_id: int = 0
    num_hosts: int = 1


@dataclasses.dataclass
class TrainOptions:
    learning_rate: float = 0.16
    wd: float = 0.0
    optimizer: str = "adagrad"
    lr_schedule: str = "cosine"
    num_epochs: int = 1
    train_limit: int = -1             # TSV: rows an epoch (-1: the split's size)
    test_limit: int = -1
    display_interval: int = 100
    test_interval: int = 2000
    max_train_steps: int = -1
    max_eval_steps: int = -1
    test_only_at_last_step: bool = False
    grad_clip: Optional[float] = 5.0  # None: no clip
    adagrad_eps: float = 1e-2         # Adagrad's eps, dense and table alike
    no_reg_param_name: Optional[str] = None
    activation: str = "relu"
    seed: int = 0
    logging_dir: Optional[str] = None
    # >0: train over a (data, model) mesh of every process with this model
    # size (parallel/): the table row-sharded over the model ranks, the batch
    # over the data ranks.  Several processes need it.
    mesh_model: int = 0
    # "bfloat16" (or "bf16") runs the model's activations in bf16; the
    # parameters, table, optimizer state and logits stay float32.
    compute_dtype: str = "float32"
    report_flops: bool = False        # print params + per-example FLOPs, dump the graph
    profile_dir: Optional[str] = None  # write a torch.profiler trace of the training
    # The dot-product and transformer nodes: "auto" (the kernels on the card,
    # the plain versions on the CPU), "xla" (the plain versions), "pallas"
    # (the kernels; raises on the CPU).  The JAX package's names.
    attention_impl: str = "auto"
    # The table and its Adagrad accumulator in host RAM; the card gets the
    # looked-up stem and returns its gradient (parallel/host_embedding.py).
    place_embedding_on_cpu: bool = False
    # "pickle" (one file) or "orbax" (a directory: arrays/ and sidecar.json).
    ckpt_backend: str = "pickle"
    # "auto": the sparse-embedding step for adagrad with wd = 0, else the
    # dense-gradient step; True / False force one (True with another
    # optimizer trains the other parameters with it).
    sparse_embedding: Any = "auto"
    micro_batches: int = 1            # sparse step only: slices a batch
    # Every choice runs the touched-row update (the kernel on the card);
    # train_supernet refuses "sweep", as the JAX package does.
    table_update: str = "auto"
    device: str = "cuda"


def _validate_data(data: DataOptions) -> None:
    if data.data_source not in ("tsv", "synthetic"):
        raise ValueError(f"unknown data_source {data.data_source!r}")
    if data.data_source == "tsv" and not data.root_dir:
        raise ValueError("data_source 'tsv' needs root_dir (--root_dir), the directory "
                         "that holds shard-*/")


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _compute_dtype(train: TrainOptions) -> torch.dtype:
    """The activations' dtype of `train.compute_dtype` (as
    `nasrec_tpu/workloads.py :: _compute_dtype`)."""
    try:
        return COMPUTE_DTYPES[train.compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {train.compute_dtype!r}: one of "
                         f"{', '.join(COMPUTE_DTYPES)}") from None


# attention_impl (the JAX package's names) -> the port's impl of the
# dot-product and transformer nodes.
MODEL_IMPLS = {"auto": "auto", "xla": "plain", "pallas": "kernel"}


def _model_impl(attention_impl: str) -> str:
    try:
        return MODEL_IMPLS[attention_impl]
    except KeyError:
        raise ValueError(f"unknown attention_impl {attention_impl!r}: one of "
                         f"{', '.join(MODEL_IMPLS)}") from None


def _use_sparse_embedding(train: TrainOptions) -> bool:
    if isinstance(train.sparse_embedding, bool):
        return train.sparse_embedding
    return train.optimizer == "adagrad" and train.wd == 0.0


def _validate_train_options(train: TrainOptions) -> None:
    """Reject conflicting option combinations up front (the JAX package's
    refusals, with its reasons)."""
    if train.ckpt_backend == "orbax" and host_info()[1] > 1:
        raise ValueError(
            "ckpt_backend='orbax' is not supported under multi-process runs: "
            "the end-of-run writers run on process 0 only, and a collective "
            "checkpoint save would deadlock with a single caller — use "
            "ckpt_backend='pickle' (its per-host sharded variant lives in "
            "nasrec_tpu_torch/parallel)"
        )
    if train.mesh_model > 0 and train.place_embedding_on_cpu:
        raise ValueError(
            "place_embedding_on_cpu and mesh_model are mutually exclusive: "
            "the mesh path shards the table over device memory"
        )
    if (train.mesh_model > 0 and train.micro_batches > 1
            and not _use_sparse_embedding(train)):
        raise ValueError(
            "micro_batches > 1 with mesh_model requires the sparse-embedding "
            "path (adagrad, wd=0 or sparse_embedding=True); the dense mesh "
            "step has no gradient-accumulation support"
        )
    if train.place_embedding_on_cpu and train.micro_batches > 1:
        raise ValueError(
            "micro_batches > 1 is not supported with place_embedding_on_cpu"
        )
    if train.place_embedding_on_cpu and train.optimizer != "adagrad":
        raise ValueError(
            "place_embedding_on_cpu trains the host table with Adagrad "
            f"(ref semantics); optimizer={train.optimizer!r} would silently "
            "diverge from the on-device run — use adagrad or keep the table "
            "on device"
        )
    if train.place_embedding_on_cpu and train.wd > 0.0:
        raise ValueError(
            "place_embedding_on_cpu cannot apply the L2 loss term to the "
            "host-resident table (that would be a dense full-table update "
            "per step); wd > 0 would silently diverge from the on-device "
            "run — use wd=0 with offload"
        )


def _validate(data: DataOptions, train: TrainOptions) -> None:
    _validate_train_options(train)
    _compute_dtype(train)
    _model_impl(train.attention_impl)
    if train.micro_batches < 1:
        raise ValueError(f"micro_batches must be at least 1, got {train.micro_batches}")
    if train.micro_batches > 1 and not _use_sparse_embedding(train):
        # The JAX package's single-device dense step ignores the flag.
        raise ValueError("micro_batches > 1 needs the sparse-embedding step "
                         "(adagrad with wd = 0, or sparse_embedding=True)")
    make_optimizer(train.optimizer)
    _validate_data(data)


def _multi_process_check(train: TrainOptions) -> bool:
    """True under several processes, which need the mesh."""
    if host_info()[1] <= 1:
        return False
    if train.mesh_model <= 0:
        raise ValueError(
            "multi-process training requires --mesh_model > 0 (the "
            "(data, model) mesh is what the per-process batch shards "
            "are assembled onto)"
        )
    return True


def _globalize_iterators(mesh, train_iter_fn, test_iter_fn, *, slice_local: bool):
    """Multi-process batches: each rank feeds the rows of its data index.
    slice_local=True is the replicated stream (synthetic data: every rank
    makes the same global batch) — a rank keeps rows
    [data_index * B / data, (data_index + 1) * B / data), so the data ranks
    together feed the one-process batch.  slice_local=False is the
    host-sharded stream (TSV: each data index reads its own shards) — the
    local batch is the rank's part as it comes.  The ranks of one data row
    feed the same rows.  Every rank must yield the same number of batches
    (the steps are collective)."""

    def local(x):
        if not slice_local:
            return x
        if x.shape[0] % mesh.data:
            raise ValueError(
                f"replicated batch of {x.shape[0]} rows does not divide across "
                f"{mesh.data} data ranks — use a batch size that is a multiple "
                "of the data size")
        per = x.shape[0] // mesh.data
        return x[mesh.data_index * per:(mesh.data_index + 1) * per]

    def wrap(it_fn):
        def wrapped(*a, **k):
            for batch in it_fn(*a, **k):
                yield tuple(local(x) for x in batch)
        return wrapped

    return wrap(train_iter_fn), wrap(test_iter_fn)


def _full_table(t: torch.Tensor, mesh, rows: int):
    """A table (or a slot of it) gathered from the model ranks, without the
    sharding pad (checkpoints hold exactly sum(vocab) rows), as host numpy
    (collective)."""
    return mesh.gather_rows(t.detach())[:rows].cpu().numpy()


def _with_table(tree: Dict, table) -> Dict:
    out = dict(tree)
    out["embedding"] = {**tree["embedding"], "table": table}
    return out


def _saved_state(state, rows: int, mesh=None, host_emb=None, with_opt: bool = True):
    """The JAX package's (params, opt_state) pytrees of a run's state, the
    table whole: gathered from a mesh's model ranks and unpadded, or taken
    from host RAM (its accumulator as the table's slot of an Adagrad state).
    Collective under a mesh."""
    params = to_jax_params(state.model)
    opt = to_jax_opt_state(state.model, state.opt_state) if with_opt else None
    if mesh is not None:
        params = _with_table(params, _full_table(state.model.embedding.table, mesh, rows))
        if with_opt:
            tables = [_full_table(sl[TABLE], mesh, rows) for sl in slot_dicts(state.opt_state)]
            if isinstance(opt, dict):
                opt = _with_table(opt, tables[0])
            else:
                opt = type(opt)(*[_with_table(t, tab) if isinstance(t, dict) else t
                                  for t, tab in zip(opt, tables + [None])])
    elif host_emb is not None:
        params = _with_table(params, host_emb.table)
        if with_opt:
            opt = _with_table(opt, host_emb.acc)
    return params, opt


def _train_steps_per_epoch(data: DataOptions, train: TrainOptions) -> int:
    if train.max_train_steps != -1:
        return train.max_train_steps
    if data.data_source == "synthetic":
        return data.synthetic_train_examples // data.train_batch_size
    limit = train.train_limit
    if limit == -1:
        spec = DATASETS[data.dataset]
        limit = spec.num_trainval if data.train_split == "trainval" else spec.num_train
    return limit // data.train_batch_size


def _max_eval_steps(data: DataOptions, train: TrainOptions) -> int:
    if train.max_eval_steps != -1:
        return train.max_eval_steps
    if train.test_limit != -1:
        return max(-(-train.test_limit // data.test_batch_size), 1)
    return -1


def _spec_and_vocab(data: DataOptions):
    spec = DATASETS[data.dataset]
    if data.data_source == "synthetic":
        return spec, tuple([data.synthetic_vocab] * spec.num_sparse)
    return spec, spec.vocab_sizes(data.vocab_cap)


def _make_iterators(data: DataOptions, device):
    """(train_iter_fn, test_iter_fn) of batches of tensors on `device`: the
    synthetic stream (made on the device), or the TSV shards through the
    host pipeline and device_prefetch."""
    spec = DATASETS[data.dataset]
    if data.data_source == "synthetic":
        sspec = SyntheticSpec(num_dense=spec.num_dense, num_sparse=spec.num_sparse,
                              vocab=data.synthetic_vocab)

        def train_iter():
            return synthetic_batches(data.synthetic_train_examples, data.train_batch_size,
                                     sspec, seed=0, loop=True, device=device)

        def test_iter():
            return synthetic_batches(data.synthetic_test_examples, data.test_batch_size,
                                     sspec, seed=1, device=device)

        return train_iter, test_iter
    host_train, host_test = make_dataset_iterators(
        data.dataset, data.root_dir,
        train_batch_size=data.train_batch_size, test_batch_size=data.test_batch_size,
        train_split=data.train_split, validate_split=data.validate_split,
        vocab_cap=data.vocab_cap, host_id=data.host_id, num_hosts=data.num_hosts,
    )
    return (lambda: device_prefetch(host_train(), device),
            lambda: device_prefetch(host_test(), device))


def _make_steps(train: TrainOptions, sched, mesh=None, has_masks: bool = False,
                bag_sizes=None):
    """(optimizer, train step, eval step): the sparse-embedding step or the
    dense-gradient step, by `_use_sparse_embedding`, on one device or over
    the mesh, with its fresh state's optimizer.  `bag_sizes`: a multi-hot
    model's bags (the sparse step only)."""
    opt = make_optimizer(train.optimizer, train.adagrad_eps)
    impl, cdt = _model_impl(train.attention_impl), _compute_dtype(train)
    common = dict(grad_clip=train.grad_clip, l2_reg=train.wd,
                  l2_exclude=train.no_reg_param_name, compute_dtype=cdt, impl=impl,
                  has_masks=has_masks, mesh=mesh)
    if _use_sparse_embedding(train):
        # attention_impl picks the nodes' impl; the table update, as in the
        # JAX package, is not switched by it.
        step = make_sparse_embedding_train_step(
            sched, optimizer=opt, microbatch=train.micro_batches, table_impl="auto",
            adagrad_eps=train.adagrad_eps, bag_sizes=bag_sizes, **common)
    else:
        step = make_train_step(opt, sched, **common)
    if mesh is not None:
        return opt, step, make_sharded_eval_step(mesh, impl, has_masks, cdt)
    return opt, step, make_eval_step(impl=impl, has_masks=has_masks, compute_dtype=cdt)


def _offload_steps(train: TrainOptions, sched, host_emb, has_masks: bool = False):
    """(optimizer, train step, eval step) with the table in host RAM."""
    opt = make_optimizer(train.optimizer)
    impl, cdt = _model_impl(train.attention_impl), _compute_dtype(train)
    step = make_host_offload_train_step(
        opt, sched, host_emb, grad_clip=train.grad_clip, l2_reg=train.wd,
        l2_exclude=train.no_reg_param_name, impl=impl, has_masks=has_masks,
        compute_dtype=cdt)
    return opt, step, make_host_offload_eval_step(host_emb, impl, has_masks, cdt)


def _init_state(model, opt, train: TrainOptions):
    if _use_sparse_embedding(train):
        return init_sparse_train_state(model, opt)
    return init_train_state(model, opt)


def _report_model_stats(model, num_dense: int, log_fn,
                        logging_dir: Optional[str] = None) -> None:
    """Parameters and forward FLOPs an example (`profiling.count_flops` of
    the plain forward at batch 1: the matmul FLOPs, which the kernels count
    alike), in the JAX package's format.  With a logging_dir, also the
    model's graph as text in `model_graph/`: the module tree and each
    parameter's shape and dtype (the JAX package writes the forward's
    StableHLO and jaxpr there).  A failed dump prints and the run goes on.
    `model` is a fixed subnet or DLRM-DCNv2 (its ids a row: the stem's
    `columns`)."""
    dev = model.final.weight.device
    dense = torch.zeros((1, num_dense), dtype=torch.float32, device=dev)
    cat = torch.zeros((1, model.embedding.columns), dtype=torch.int32, device=dev)
    with torch.no_grad():
        flops = profiling.count_flops(lambda m, d, c: fixed_apply(m, d, c, impl="plain"),
                                      model, dense, cat)
    log_fn(f"FLOPS: {flops / 1e6:.4f} M/example \t "
           f"Params: {profiling.count_params(model) / 1e6:.4f} M")
    if not logging_dir or host_info()[0] != 0:
        return
    try:
        gdir = os.path.join(logging_dir, "model_graph")
        os.makedirs(gdir, exist_ok=True)
        with open(os.path.join(gdir, "modules.txt"), "w") as f:
            f.write(f"{model}\n")
        with open(os.path.join(gdir, "parameters.txt"), "w") as f:
            for name, p in model.named_parameters():
                f.write(f"{name}\t{tuple(p.shape)}\t{p.dtype}\n")
        log_fn(f"model graph dumped to {gdir}")
    except OSError as e:  # a graph dump must never end a run
        log_fn(f"model graph dump unavailable: {e}")


def _chief_dir(path: Optional[str]) -> Optional[str]:
    """`path` on rank 0 and None elsewhere: one writer of metrics.jsonl and
    trace.json per (possibly shared) filesystem."""
    return path if host_info()[0] == 0 else None


class _MaybeProfile:
    """A torch.profiler trace of the enclosed run (CPU activity, and the
    card's where there is one), written as `<profile_dir>/trace.json` in the
    Chrome trace format; nothing without a profile_dir.  A profiler that
    fails prints and the run goes on, as in the JAX package."""

    def __init__(self, profile_dir: Optional[str]):
        self.dir = profile_dir
        self.prof = None

    def __enter__(self):
        if self.dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                self.prof = torch.profiler.profile(activities=activities)
                self.prof.__enter__()
            except Exception as e:  # profiling must never end a run
                print(f"profiler unavailable: {e}")
                self.prof = None
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            try:
                self.prof.__exit__(None, None, None)
                os.makedirs(self.dir, exist_ok=True)
                self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
            except Exception as e:  # profiling must never end a run
                print(f"profiler trace not written: {e}")
        return False


def _train_epochs(step, eval_step, state, train_iter, test_iter, data: DataOptions,
                  train: TrainOptions, steps_per_epoch: int, log_fn, fetch=None):
    """`train.num_epochs` epochs of `train_and_test_one_epoch`, writing
    metrics.jsonl (rank 0) and a profiler trace with a profile_dir ->
    (state, epoch logs, best params)."""
    writer = MetricsWriter(_chief_dir(train.logging_dir))
    epoch_logs, best = [], None
    with _MaybeProfile(_chief_dir(train.profile_dir)):
        for epoch in range(train.num_epochs):
            state, logs, best_ep = train_and_test_one_epoch(
                step, eval_step, state, train_iter(), test_iter,
                epoch=epoch,
                display_interval=train.display_interval,
                test_interval=train.test_interval,
                max_train_steps=steps_per_epoch,
                max_eval_steps=_max_eval_steps(data, train),
                test_only_at_last_step=train.test_only_at_last_step,
                log_fn=log_fn,
                metrics_writer=writer,
                fetch=fetch,
            )
            epoch_logs.append(logs)
            if best_ep is not None:
                best = best_ep
    writer.close()
    return state, epoch_logs, best


def train_fixed_subnet(
    choice_payload: Dict[str, Any],
    data: DataOptions = DataOptions(),
    train: TrainOptions = TrainOptions(),
    use_layernorm: bool = False,   # the reference trains best models without LN
    use_final_sigmoid: bool = False,
    last_n_blocks_out: int = 1,
    log_fn: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Train one fixed subnet from scratch (ref: main_train.py:77-221)."""
    _validate(data, train)
    device = resolve_device(train.device)
    spec, vocab = _spec_and_vocab(data)
    choice = {"macro": choice_payload["macro"], "micro": choice_payload["micro"]}
    space = OPS_CONFIG_LIB[choice_payload.get("config", "xlarge")]
    num_blocks = int(choice_payload.get("num_blocks", len(choice["macro"])))
    plan = build_fixed_plan(
        choice, space, num_blocks, spec.num_dense, spec.num_sparse, vocab,
        use_layernorm=use_layernorm, activation=train.activation,
        use_final_sigmoid=use_final_sigmoid, last_n_blocks_out=last_n_blocks_out,
    )
    model = fixed_init(plan, train.seed, device)

    steps_per_epoch = _train_steps_per_epoch(data, train)
    num_train_steps = steps_per_epoch * train.num_epochs
    num_warmup = steps_per_epoch // 10 // train.num_epochs  # ref: main_train.py:164
    sched = make_lr_schedule(train.lr_schedule, train.learning_rate,
                             num_train_steps, num_warmup)
    if train.table_update not in ("auto", "scatter", "sweep"):
        raise ValueError(f"unknown table_update {train.table_update!r}")
    if train.table_update == "sweep" and train.place_embedding_on_cpu:
        raise ValueError("table_update='sweep' is a device-table path "
                         "(not compatible with place_embedding_on_cpu)")
    if train.table_update == "sweep" and not _use_sparse_embedding(train):
        raise ValueError("table_update='sweep' requires the sparse-embedding path "
                         "(adagrad, wd=0 or sparse_embedding=True)")
    if train.report_flops:      # of the whole model, before the table moves
        _report_model_stats(model, spec.num_dense, log_fn, logging_dir=train.logging_dir)
    mesh, host_emb, fetch = None, None, None
    if train.mesh_model > 0:
        mesh = make_mesh(model=train.mesh_model)
        opt, step, eval_step = _make_steps(train, sched, mesh)
        state = shard_train_state(_init_state(model, opt, train), mesh)
        fetch = mesh.fetch
    elif train.place_embedding_on_cpu:
        host_emb = HostEmbedding(detach_table(model), table_offsets(vocab))
        opt, step, eval_step = _offload_steps(train, sched, host_emb)
        state = init_train_state(model, opt)
    else:
        opt, step, eval_step = _make_steps(train, sched)
        state = _init_state(model, opt, train)
    train_iter, test_iter = _make_iterators(data, device)
    if _multi_process_check(train):
        train_iter, test_iter = _globalize_iterators(
            mesh, train_iter, test_iter, slice_local=data.data_source == "synthetic")

    state, epoch_logs, best = _train_epochs(step, eval_step, state, train_iter, test_iter,
                                            data, train, steps_per_epoch, log_fn, fetch)

    params, _ = _saved_state(state, int(sum(vocab)), mesh, host_emb, with_opt=False)
    _dump_logs(train.logging_dir, epoch_logs,
               {"choice": choice_payload, "data": dataclasses.asdict(data),
                "train": dataclasses.asdict(train)},
               {"params": params, "step": state.step},
               ckpt_backend=train.ckpt_backend)
    return {"state": state, "logs": epoch_logs, "best_params": best, "plan": plan,
            "host_embedding": host_emb}


def train_dcnv2(
    config: DCNv2Config,
    data: DataOptions = DataOptions(data_source="synthetic"),
    train: TrainOptions = TrainOptions(),
    log_fn: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Train DLRM-DCNv2 (models/dcn.py) on synthetic multi-hot batches
    through the sparse-embedding step, on one device.  Each slot's table
    holds min(its rows, data.synthetic_vocab) rows; every width is
    `config`'s.  Criteo 1TB's own files are not read, and the table is not
    sharded over processes (refused)."""
    _validate(data, train)
    if data.data_source != "synthetic":
        raise ValueError("DLRM-DCNv2 trains on synthetic multi-hot batches "
                         "(data_source='synthetic'); Criteo 1TB's files are not read")
    if train.mesh_model > 0 or train.place_embedding_on_cpu or host_info()[1] > 1:
        raise ValueError("DLRM-DCNv2's multi-hot bags run on one device: no mesh, no "
                         "host-RAM table, one process")
    if not _use_sparse_embedding(train):
        raise ValueError("DLRM-DCNv2 trains its table with the sparse-embedding step "
                         "(adagrad with wd = 0)")
    device = resolve_device(train.device)
    cfg = dataclasses.replace(
        config, vocab_sizes=tuple(min(int(v), data.synthetic_vocab) for v in config.vocab_sizes),
        init_rows=config.init_rows or config.vocab_sizes)
    model = dcnv2_init(cfg, train.seed, device)
    steps_per_epoch = _train_steps_per_epoch(data, train)
    sched = make_lr_schedule(train.lr_schedule, train.learning_rate,
                             steps_per_epoch * train.num_epochs,
                             steps_per_epoch // 10 // train.num_epochs)
    if train.report_flops:
        _report_model_stats(model, cfg.num_dense, log_fn, logging_dir=train.logging_dir)
    opt, step, eval_step = _make_steps(train, sched, bag_sizes=cfg.bag_sizes)
    state = _init_state(model, opt, train)

    def train_iter():
        return multihot_batches(data.synthetic_train_examples, data.train_batch_size,
                                cfg.vocab_sizes, cfg.bag_sizes, cfg.num_dense, seed=0,
                                loop=True, device=device)

    def test_iter():
        return multihot_batches(data.synthetic_test_examples, data.test_batch_size,
                                cfg.vocab_sizes, cfg.bag_sizes, cfg.num_dense, seed=1,
                                device=device)

    state, epoch_logs, best = _train_epochs(step, eval_step, state, train_iter, test_iter,
                                            data, train, steps_per_epoch, log_fn)
    params = {n: p.detach().cpu().numpy() for n, p in state.model.named_parameters()}
    _dump_logs(train.logging_dir, epoch_logs,
               {"dcnv2": dataclasses.asdict(cfg), "data": dataclasses.asdict(data),
                "train": dataclasses.asdict(train)},
               {"params": params, "step": state.step}, ckpt_backend=train.ckpt_backend)
    return {"state": state, "logs": epoch_logs, "best_params": best, "config": cfg}


@dataclasses.dataclass
class SupernetOptions:
    config: str = "xlarge"
    num_blocks: int = 7
    use_layernorm: bool = True
    strategy: str = "default"
    anypath_choice: str = "binomial-0.5"
    supernet_training_steps: int = 15000
    checkpoint_path: Optional[str] = None   # resume
    # Candidate list for 'evo-2shot-path' (ref flag: train_supernet.py:305).
    evo_2shot_candidates_path: Optional[str] = None
    # Seed the embedding table from a donor checkpoint (ref:
    # train_supernet.py:413, supernet.py:368-383).
    pretrained_emb_path: Optional[str] = None
    # "sampled" (the reference's eval: a random subnet per eval batch, ref:
    # train_utils.py:144-147) or "full-path" (every node active).
    eval_path: str = "sampled"
    use_final_sigmoid: bool = False         # ref: supernet.py:284-287
    last_n_blocks_out: int = 1              # ref constructor param: supernet.py:226


def train_supernet(
    sn: SupernetOptions = SupernetOptions(),
    data: DataOptions = DataOptions(train_batch_size=512, test_batch_size=4096),
    train: TrainOptions = TrainOptions(learning_rate=0.12),
    log_fn: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """One-shot supernet training (ref: train_supernet.py:66-238): every step
    samples a subnet on the host, and one train step serves every subnet
    through masks selected on the device."""
    if train.table_update not in ("auto", "scatter"):
        raise ValueError("train_supernet supports table_update='scatter' only "
                         "(sweep targets large-batch fixed-subnet training)")
    _validate(data, train)
    device = resolve_device(train.device)
    spec, vocab = _spec_and_vocab(data)
    space = OPS_CONFIG_LIB[sn.config]
    cfg = SuperNetConfig(
        space=space, num_blocks=sn.num_blocks, num_dense=spec.num_dense,
        num_sparse=spec.num_sparse, vocab_sizes=vocab,
        use_layernorm=sn.use_layernorm, activation=train.activation,
        use_final_sigmoid=sn.use_final_sigmoid, last_n_blocks_out=sn.last_n_blocks_out,
    )
    model = supernet_init(cfg, train.seed, device)
    if sn.pretrained_emb_path:
        load_embedding_from_checkpoint(model, sn.pretrained_emb_path)
        log_fn(f"seeded embedding table from {sn.pretrained_emb_path}")

    steps_per_epoch = _train_steps_per_epoch(data, train)
    num_train_steps = steps_per_epoch * train.num_epochs
    num_warmup = steps_per_epoch // 10 // train.num_epochs
    sched = make_lr_schedule(train.lr_schedule, train.learning_rate,
                             num_train_steps, num_warmup)
    start_step, resume_opt = 0, None
    if sn.checkpoint_path:
        ckpt = load_any_checkpoint(sn.checkpoint_path)
        model.load_state_dict(from_jax_params(ckpt["params"], cfg))
        resume_opt = ckpt.get("opt_state")
        start_step = int(ckpt.get("step", 0))
        log_fn(f"resumed from {sn.checkpoint_path} at step {start_step}")

    def resume(state):
        if resume_opt is not None:
            copy_state_(state.opt_state, from_jax_opt_state(as_opt_state(resume_opt), cfg))
        return state

    mesh, host_emb, fetch = None, None, None
    if train.mesh_model > 0:
        mesh = make_mesh(model=train.mesh_model)
        opt, step, eval_step = _make_steps(train, sched, mesh, has_masks=True)
        state = shard_train_state(resume(_init_state(model, opt, train)), mesh)
        fetch = mesh.fetch
    elif train.place_embedding_on_cpu:
        # As in the JAX package, the host table starts from the (resumed)
        # parameters and a zero accumulator.
        host_emb = HostEmbedding(detach_table(model), table_offsets(vocab))
        opt, step, eval_step = _offload_steps(train, sched, host_emb, has_masks=True)
        state = init_train_state(model, opt)
    else:
        opt, step, eval_step = _make_steps(train, sched, has_masks=True)
        state = resume(_init_state(model, opt, train))
    state.step = start_step
    candidates = None
    if sn.evo_2shot_candidates_path:
        with open(sn.evo_2shot_candidates_path, "rb") as f:
            candidates = pickle.load(f)
        log_fn(f"loaded {len(candidates)} evo-2shot candidates")
    sampler = ChoiceSampler(
        space, sn.num_blocks, strategy=sn.strategy, anypath_choice=sn.anypath_choice,
        supernet_training_steps=sn.supernet_training_steps, seed=train.seed,
        candidate_choices=candidates,
    )
    sampler.step_counter = start_step - 1
    if sn.eval_path == "sampled":
        # The candidates go to the eval sampler too: without them an
        # evo-2shot-path eval has nothing to draw from (the JAX package's
        # eval sampler takes none, and raises there).
        eval_sampler = ChoiceSampler(space, sn.num_blocks, strategy=sn.strategy,
                                     anypath_choice=sn.anypath_choice, seed=train.seed + 1,
                                     candidate_choices=candidates)
        eval_masks = lambda: choice_to_masks(eval_sampler(), space, sn.num_blocks).to(device)
    else:
        eval_masks = choice_to_masks(full_path_choice(space, sn.num_blocks), space,
                                     sn.num_blocks).to(device)
    train_iter, test_iter = _make_iterators(data, device)
    if _multi_process_check(train):
        train_iter, test_iter = _globalize_iterators(
            mesh, train_iter, test_iter, slice_local=data.data_source == "synthetic")
    if mesh is not None or host_emb is not None:
        # Mesh and offload: host masks a step, as in the JAX package (the
        # device buffer serves the one-device steps); the same draws.
        mask_buffer = lambda: choice_to_masks(sampler(), space, sn.num_blocks)
    else:
        # Refilled `size` draws at a time, as in the JAX package, so that the
        # sampler's counter (and its warmup) advance alike in both.
        mask_buffer = DeviceMaskBuffer(sampler, size=min(256, max(steps_per_epoch, 1)),
                                       device=device)

    writer = MetricsWriter(_chief_dir(train.logging_dir))
    epoch_logs = []
    for epoch in range(train.num_epochs):
        state, logs, _ = train_and_test_one_epoch(
            step, eval_step, state, train_iter(), test_iter,
            epoch=epoch,
            sampler=mask_buffer,
            eval_masks=eval_masks,
            display_interval=train.display_interval,
            test_interval=train.test_interval,
            max_train_steps=steps_per_epoch,
            max_eval_steps=_max_eval_steps(data, train),
            test_only_at_last_step=train.test_only_at_last_step,
            keep_best=False,
            log_fn=log_fn,
            metrics_writer=writer,
            fetch=fetch,
        )
        epoch_logs.append(logs)
    writer.close()

    params, opt_tree = _saved_state(state, int(sum(vocab)), mesh, host_emb)
    ckpt_payload = {
        "params": params,
        "opt_state": opt_tree,
        "step": int(state.step),
        "supernet": dataclasses.asdict(sn),
    }
    _dump_logs(train.logging_dir, epoch_logs,
               {"supernet": dataclasses.asdict(sn), "data": dataclasses.asdict(data),
                "train": dataclasses.asdict(train)},
               ckpt_payload, ckpt_name="supernet_checkpoint.pkl",
               ckpt_backend=train.ckpt_backend)
    return {"state": state, "logs": epoch_logs, "cfg": cfg, "host_embedding": host_emb}


def _dump_logs(logging_dir: Optional[str], epoch_logs, options: Dict, ckpt_payload: Dict,
               ckpt_name: str = "checkpoint.pkl", ckpt_backend: str = "pickle") -> None:
    """configs_args.json, train_test_logs.{json,pickle} and the checkpoint
    (`train/checkpoint.py`: the JAX package's layout), as the JAX package
    writes them; nothing without a logging dir."""
    if not logging_dir or host_info()[0] != 0:
        return      # one writer per (possibly shared) filesystem
    os.makedirs(logging_dir, exist_ok=True)
    with open(os.path.join(logging_dir, "configs_args.json"), "w") as f:
        json.dump(options, f, indent=2, default=str)
    with open(os.path.join(logging_dir, "train_test_logs.pickle"), "wb") as f:
        pickle.dump(epoch_logs, f)
    with open(os.path.join(logging_dir, "train_test_logs.json"), "w") as f:
        json.dump(epoch_logs, f)
    if ckpt_backend == "orbax":
        ckpt_name = os.path.splitext(ckpt_name)[0] + ".orbax"
    save_checkpoint_any(os.path.join(logging_dir, ckpt_name), ckpt_payload, ckpt_backend)


# ---------------------------------------------------------------------------
# Search (random / regularized EA) over a trained supernet
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SearchOptions:
    method: str = "regularized-ea"   # regularized-ea | random
    config: str = "xlarge"
    num_blocks: int = 7
    use_layernorm: bool = True
    ckpt_path: Optional[str] = None
    learning_rate: float = 0.04
    max_train_steps: int = 500
    max_eval_steps: int = 150
    n_generations: int = 240
    n_childs: int = 8
    init_population: int = 128
    sample_size: int = 64
    ea_top_k: int = 2
    budget: int = 200                # random search budget
    criterion: str = "test_loss"
    group_size: int = 8
    seed: int = 0
    # "final-only" (default): the K candidates of a group advance together
    # over the frozen body; "whole" / "layernorm-calibrate" fine-tune more
    # of the net (ref --finetune_whole_supernet), with batch_finetune (the
    # default) K full copies as one step a group, else one candidate at a
    # time, as the JAX package's two forms of those modes do.
    finetune_mode: str = "final-only"
    batch_finetune: bool = True
    # Latency-aware search (criterion="test_loss_penalty_lat"):
    # objective = test_loss + beta * (latency / target_latency - 1)
    # (TuNAS-style relaxation, ref: searcher.py:65-73).  With beta != 0 each
    # distinct plan's forward latency at latency_batch_size is estimated by
    # the cost model ("cost-model": profiling.estimate_latency_cost_model on
    # the meta device, against one chip calibration a process) or timed
    # ("measured": the forward through the kernels on the card, or the CPU).
    beta: float = 0.0
    target_latency: float = -1.0
    latency_batch_size: int = 512
    latency_trials: int = 50
    latency_estimator: str = "cost-model"
    # The dot-product and transformer nodes of the candidate evaluator and the
    # measured latency (TrainOptions.attention_impl); in the whole-net mode it
    # picks the table update's impl too.
    attention_impl: str = "auto"
    device: str = "cuda"


def _validate_search(so: SearchOptions, data: DataOptions) -> None:
    _validate_data(data)
    if so.latency_estimator not in ("cost-model", "measured"):
        raise ValueError(f"unknown latency_estimator {so.latency_estimator!r}")
    _model_impl(so.attention_impl)


def _search_setup(so: SearchOptions, data: DataOptions, warning: str, log_fn):
    """The candidate evaluator over the supernet (from so.ckpt_path, a
    checkpoint of either package, or random weights from so.seed) and the
    data streams, on so.device."""
    device = resolve_device(so.device)
    spec, vocab = _spec_and_vocab(data)
    cfg = SuperNetConfig(
        space=OPS_CONFIG_LIB[so.config], num_blocks=so.num_blocks, num_dense=spec.num_dense,
        num_sparse=spec.num_sparse, vocab_sizes=vocab, use_layernorm=so.use_layernorm,
    )
    supernet = supernet_init(cfg, so.seed, device)
    if so.ckpt_path:
        ckpt = load_any_checkpoint(so.ckpt_path)
        supernet.load_state_dict(from_jax_params(ckpt["params"], cfg))
    else:
        # The port draws its own init (not the JAX package's random weights).
        log_fn(warning)
    evaluator = make_candidate_evaluator(
        cfg, supernet,
        learning_rate=so.learning_rate,
        max_train_steps=so.max_train_steps,
        max_eval_steps=so.max_eval_steps,
        finetune_mode=so.finetune_mode,
        batch_candidates=so.batch_finetune,
        impl=_model_impl(so.attention_impl),
    )
    return evaluator, _make_iterators(data, device)


def evaluate_choices_from_supernet(
    choices: List[Dict],
    so: SearchOptions = SearchOptions(),
    data: DataOptions = DataOptions(train_batch_size=512, test_batch_size=8192),
    log_fn: Callable[[str], None] = print,
) -> List[Dict]:
    """Weight-shared evaluation of an explicit candidate list (no search):
    restore the supernet checkpoint, fine-tune and score each choice in
    group_size groups (ref: eval_subnet_from_supernet.py's fixed
    --supernet_test_path mode, lines 220-260)."""
    _validate_search(so, data)
    evaluator, (train_iter_fn, test_iter_fn) = _search_setup(
        so, data, "WARNING: no supernet checkpoint; scoring against RANDOM weights", log_fn)
    results: List[Dict] = []
    for s in range(0, len(choices), so.group_size):
        group = choices[s : s + so.group_size]
        results.extend(evaluator(group, train_iter_fn, test_iter_fn, log_fn=log_fn))
        log_fn(f"evaluated {min(s + so.group_size, len(choices))}/{len(choices)}")
    return results


# calibrate_chip's result, once a process for each device type (the cost
# model's denominators need only be consistent across candidates).
_CALIBRATION: Dict[str, dict] = {}


def _calibration(device: torch.device) -> dict:
    if device.type not in _CALIBRATION:
        _CALIBRATION[device.type] = profiling.calibrate_chip(
            matmul_dim=2048, copy_mb=64, trials=8, device=device.type)
    return _CALIBRATION[device.type]


def _choice_latency_fn(so: SearchOptions, data: DataOptions) -> Callable[[Choice], float]:
    """choice -> forward latency in seconds of its fixed subnet at
    so.latency_batch_size (as `nasrec_tpu/workloads.py ::
    _measure_choice_latency`), cached by plan: the frozen FixedPlan of two
    candidates with the same structure is equal.  "measured" times a freshly
    initialised model's forward (`profiling.measure_latency`, through the
    kernels on the card) and frees it; "cost-model" counts the plain forward
    on the meta device (`profiling.estimate_latency_cost_model`)."""
    device = resolve_device(so.device)
    spec, vocab = _spec_and_vocab(data)
    space = OPS_CONFIG_LIB[so.config]
    impl = _model_impl(so.attention_impl)
    cache: Dict[Any, float] = {}

    def forward(model, dense, cat, impl_):
        with torch.no_grad():
            return fixed_apply(model, dense, cat, impl=impl_)

    def latency(choice: Choice) -> float:
        plan = build_fixed_plan(choice, space, so.num_blocks, spec.num_dense, spec.num_sparse,
                                vocab, use_layernorm=so.use_layernorm)
        if plan in cache:
            return cache[plan]
        if so.latency_estimator == "measured":
            model = fixed_init(plan, 0, device)
            dense = torch.zeros((so.latency_batch_size, spec.num_dense), device=device)
            cat = torch.zeros((so.latency_batch_size, spec.num_sparse), dtype=torch.int32,
                              device=device)
            lat, _ = profiling.measure_latency(forward, (model, dense, cat, impl),
                                               num_warmup_steps=5, num_trials=so.latency_trials)
            del model      # up to 196 MB of table at the search cap; keep the number only
        else:
            calib = _calibration(device)
            meta = torch.device("meta")
            dense = torch.zeros((so.latency_batch_size, spec.num_dense), device=meta)
            cat = torch.zeros((so.latency_batch_size, spec.num_sparse), dtype=torch.int32,
                              device=meta)
            lat = profiling.estimate_latency_cost_model(
                forward, (fixed_init(plan, 0, meta), dense, cat, "plain"), calib)
        cache[plan] = lat
        return lat

    return latency


def search_from_supernet(
    so: SearchOptions = SearchOptions(),
    data: DataOptions = DataOptions(train_batch_size=512, test_batch_size=8192),
    logging_dir: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
) -> List[Dict]:
    """EA / random search with weight-shared fine-tuning
    (ref: eval_subnet_from_supernet.py:220-289); writes results.pickle (the
    top results) and all_results.pickle (every candidate in evaluation
    order) into logging_dir."""
    _validate_search(so, data)
    if so.method not in ("random", "regularized-ea"):
        raise NotImplementedError(f"method {so.method}")
    evaluator, (train_iter_fn, test_iter_fn) = _search_setup(
        so, data, "WARNING: no supernet checkpoint; searching over random weights", log_fn)
    need_latency = so.criterion == "test_loss_penalty_lat" and so.beta != 0.0
    choice_latency = _choice_latency_fn(so, data)

    def eval_fn(choices):
        t0 = time.time()
        results = evaluator(choices, train_iter_fn, test_iter_fn, log_fn=log_fn)
        if need_latency:
            for r in results:
                r["latency"] = choice_latency(r["choice"])
        log_fn(f"evaluated {len(choices)} candidates in {time.time() - t0:.1f}s")
        return results

    tokenizer = Tokenizer(so.num_blocks, OPS_CONFIG_LIB[so.config], seed=so.seed)
    searcher = Searcher(
        eval_fn, tokenizer,
        SearchConfig(criterion=so.criterion, group_size=so.group_size, seed=so.seed,
                     beta=so.beta, target_latency=so.target_latency,
                     # Several processes fan the candidate groups out across
                     # themselves (ref: searcher.py:126-156).
                     distribute=host_info()[1] > 1),
        log_fn=log_fn,
    )
    if so.method == "random":
        results = searcher.random_search_from_supernet(
            budget=so.budget, top_k=min(so.ea_top_k, so.budget)
        )
    else:
        results = searcher.regularized_evolution_from_supernet(
            n_generations=so.n_generations, n_childs=so.n_childs,
            init_population=so.init_population, sample_size=so.sample_size,
            top_k=so.ea_top_k,
        )

    if logging_dir and host_info()[0] == 0:
        os.makedirs(logging_dir, exist_ok=True)
        with open(os.path.join(logging_dir, "results.pickle"), "wb") as f:
            pickle.dump(results, f)
        with open(os.path.join(logging_dir, "all_results.pickle"), "wb") as f:
            pickle.dump(searcher.all_results, f)
    return results


# ---------------------------------------------------------------------------
# Subnet-from-scratch evaluation (search-space / rank-correlation studies)
# ---------------------------------------------------------------------------


def eval_subnets_from_scratch(
    num_subnets: int = 10,
    choices: Optional[List[Choice]] = None,
    config: str = "xlarge",
    num_blocks: int = 7,
    data: DataOptions = DataOptions(),
    train: TrainOptions = TrainOptions(),
    use_layernorm: bool = False,
    logging_dir: Optional[str] = None,
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
) -> List[Dict]:
    """Train N subnets from scratch under step budgets
    (ref: eval_subnet_from_scratch.py:188-242); a diverged run gets the
    sentinel result.  Writes from_scratch_results.pickle into logging_dir."""
    _validate(data, train)
    resolve_device(train.device)
    space = OPS_CONFIG_LIB[config]
    tokenizer = Tokenizer(num_blocks, space, seed=seed)
    if choices is None:
        choices = [tokenizer.generate_random_choice() for _ in range(num_subnets)]
    results = []
    for i, choice in enumerate(choices):
        log_fn(f"--- subnet {i + 1}/{len(choices)}")
        payload = {
            "macro": choice["macro"], "micro": choice["micro"],
            "config": config, "num_blocks": num_blocks,
        }
        out = train_fixed_subnet(
            payload, data, train, use_layernorm=use_layernorm, log_fn=log_fn
        )
        logs = out["logs"][-1]
        result = {
            "choice": choice,
            "test_loss": logs["test_loss"][-1] if logs["test_loss"] else 999.99,
            "test_auroc": logs["test_AUROC"][-1] if logs["test_AUROC"] else -1,
            "test_acc": logs["test_Accuracy"][-1] if logs["test_Accuracy"] else -1,
            "hash_token": tokenizer.hash_choice(choice),
        }
        if result["test_loss"] >= 999.0:
            log_fn("subnet diverged; recording sentinel result")
        results.append(result)
    if logging_dir:
        os.makedirs(logging_dir, exist_ok=True)
        with open(os.path.join(logging_dir, "from_scratch_results.pickle"), "wb") as f:
            pickle.dump(results, f)
    return results
