"""Argparse plumbing for the port's CLIs (flag parity with
`nasrec_tpu/cli/common.py`, plus --device).  --root_dir, --train_split,
--validate_split and --train_limit read TSV shards (the default
--data_source tsv); --cap_vocab 1 caps both the tables and the TSV transform
at 0.5M rows a slot (search mode).  --synthetic_vocab sizes the tables of
--data_source synthetic (a flag of the port, which the search CLI needs to
load a supernet trained at another synthetic vocab).  --optimizer, --wd and
--micro_batches (sparse-embedding step only) run.  --report_flops 1 prints
the parameters and forward FLOPs an example and writes the model's graph
into <logging_dir>/model_graph/; --profile_dir writes a torch.profiler trace
of the training there; --attention_impl picks the dot-product and
transformer nodes' impl: auto (the kernels on the card, the plain versions on
the CPU), xla (the plain versions), pallas (the kernels; raises on the CPU).
--loss_function has one value, bce, which is what the step computes.
--mesh_model, --place_embedding_on_cpu and --ckpt_backend orbax run
(parallel/, train/checkpoint.py).  The multi-process flags
(`add_distributed_args`) bring up torch.distributed before anything else:
NCCL with --device cuda, gloo with --device cpu; every process runs the same
command with its own --process_id, and tears its process groups down before
it returns (`distributed_run`)."""

from __future__ import annotations

import argparse
import contextlib

from nasrec_tpu_torch.config import SEARCH_MAX_NUM_EMBEDDINGS
from nasrec_tpu_torch.workloads import DataOptions, TrainOptions


def add_distributed_args(p: argparse.ArgumentParser):
    """Multi-process launch flags (as the JAX CLIs'): every process runs the
    same CLI with its own --process_id; torch.distributed comes up from them
    (`maybe_initialize_distributed`) before any other work."""
    p.add_argument("--num_processes", type=int, default=0,
                   help=">1: bring up torch.distributed with this many processes "
                        "(requires --coordinator_address and --process_id on every "
                        "process)")
    p.add_argument("--process_id", type=int, default=-1,
                   help="this process's rank in [0, num_processes)")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0's rendezvous")
    p.add_argument("--host_id", type=int, default=-1,
                   help="data-shard owner id (default: this process's data index); "
                        "this process reads file shards where shard %% num_hosts == "
                        "host_id")
    p.add_argument("--num_hosts", type=int, default=0,
                   help="total data-shard readers (default: the mesh's data size)")


def maybe_initialize_distributed(args) -> None:
    """Bring up torch.distributed from the CLI flags (no-op for one process):
    NCCL for --device cuda, gloo for --device cpu."""
    num = getattr(args, "num_processes", 0)
    if num and num > 1:
        from nasrec_tpu_torch.parallel.distributed import initialize

        initialize(coordinator_address=args.coordinator_address, num_processes=num,
                   process_id=args.process_id if args.process_id >= 0 else None,
                   device=getattr(args, "device", "cuda"))


@contextlib.contextmanager
def distributed_run(args):
    """A CLI's work between bring-up (`maybe_initialize_distributed`) and
    teardown (`distributed.shutdown`), so that no process exits with a
    process group up: after work that returned, every rank first waits for
    the others; after work that raised, this rank tears its groups down at
    once and the exception goes on (the others may never reach a barrier)."""
    from nasrec_tpu_torch.parallel import distributed

    try:
        maybe_initialize_distributed(args)
        yield
    except BaseException:
        distributed.shutdown()
        raise
    distributed.shutdown(barrier=True)


def add_data_args(p: argparse.ArgumentParser, train_bs=256, test_bs=16368):
    p.add_argument("--dataset", default="criteo-kaggle",
                   choices=["criteo-kaggle", "avazu", "kdd"])
    p.add_argument("--root_dir", default="",
                   help="TSV root holding shard-*/{train,val,test,trainval}.txt")
    p.add_argument("--data_source", default="tsv", choices=["tsv", "synthetic"],
                   help="'synthetic' runs without real data")
    p.add_argument("--train_split", default="trainval", choices=["train", "trainval"])
    p.add_argument("--validate_split", default="test", choices=["val", "test"])
    p.add_argument("--train_batch_size", type=int, default=train_bs)
    p.add_argument("--test_batch_size", type=int, default=test_bs)
    p.add_argument("--cap_vocab", type=int, default=0,
                   help="1: cap embedding tables at 0.5M rows (search mode)")
    p.add_argument("--synthetic_vocab", type=int, default=DataOptions.synthetic_vocab,
                   help="rows a slot of the tables for --data_source synthetic")


def add_train_args(p: argparse.ArgumentParser, lr=0.16):
    p.add_argument("--learning_rate", type=float, default=lr)
    p.add_argument("--wd", type=float, default=0.0, help="L2 weight decay")
    p.add_argument("--optimizer", default="adagrad", choices=["adagrad", "adam", "sgd"])
    p.add_argument("--lr_schedule", default="cosine",
                   choices=["cosine", "constant", "constant-no-warmup"])
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--train_limit", type=int, default=-1,
                   help="TSV rows an epoch (-1: the train split's size)")
    p.add_argument("--test_limit", type=int, default=-1)
    p.add_argument("--display_interval", type=int, default=100)
    p.add_argument("--test_interval", type=int, default=2000)
    p.add_argument("--max_train_steps", type=int, default=-1)
    p.add_argument("--max_eval_steps", type=int, default=-1)
    p.add_argument("--test_only_at_last_step", type=int, default=0)
    p.add_argument("--activation", default="relu", choices=["relu", "silu"])
    p.add_argument("--no_reg_param_name", default=None)
    p.add_argument("--loss_function", default="bce", choices=["bce"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logging_dir", default=None)
    p.add_argument("--report_flops", type=int, default=0,
                   help="1: print params + per-example forward FLOPs, and dump the model "
                        "graph into <logging_dir>/model_graph/")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (Chrome format) of the training here")
    p.add_argument("--mesh_model", type=int, default=0,
                   help=">0: a (data, model) mesh over every process with this model "
                        "size (row-sharded embedding table, data-parallel batch)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16: the model's activations in bf16 (the JAX package's "
                        "rule); parameters, table, optimizer state and logits stay float32")
    p.add_argument("--place_embedding_on_cpu", type=int, default=0,
                   help="keep the embedding table + its optimizer state in host RAM "
                        "(ref: supernet.py:253-254)")
    p.add_argument("--micro_batches", type=int, default=1,
                   help=">1: run each batch as this many slices (sparse-embedding "
                        "step; full-batch update math, one slice's activations)")
    p.add_argument("--ckpt_backend", default="pickle", choices=["pickle", "orbax"],
                   help="checkpoint format: one pickle file, or a directory of "
                        "arrays/ (torch.distributed.checkpoint) and sidecar.json")
    add_attention_impl_arg(p)
    p.add_argument("--table_update", default="auto", choices=["auto", "scatter", "sweep"],
                   help="every choice runs the touched-row update (its kernel on the "
                        "card), the port's counterpart of the TPU's sweep; "
                        "train_supernet refuses sweep, as the JAX package does")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises without one) or the CPU")


def add_attention_impl_arg(p: argparse.ArgumentParser):
    p.add_argument("--attention_impl", default="auto", choices=["auto", "xla", "pallas"],
                   help="dot-product and transformer nodes: 'auto' = the CUDA kernels on "
                        "the card, the plain versions on the CPU; 'xla' = the plain "
                        "versions; 'pallas' = the kernels (raises on the CPU)")


def data_options(args, globalized: bool = True) -> DataOptions:
    """DataOptions from the flags.  Under several processes (torch.distributed
    already up: `maybe_initialize_distributed`), globalized=True is the
    training CLIs' contract: batch sizes are global and must divide across
    the mesh's data ranks (world size // --mesh_model); a TSV reader is host
    `host_id` of `num_hosts` (defaults: this process's data index and the
    data size; an explicit --num_hosts must equal the data size) and reads a
    local batch of the global size // num_hosts.  Synthetic streams are
    replicated and sliced by data index (workloads._globalize_iterators).
    globalized=False is the search fan-out's: each process reads the whole
    stream at the full batch size (candidate groups, not batches, are what
    is split across processes)."""
    host_id = getattr(args, "host_id", -1)
    num_hosts = getattr(args, "num_hosts", 0)
    train_bs, test_bs = args.train_batch_size, args.test_batch_size
    if getattr(args, "num_processes", 0) and args.num_processes > 1 and globalized:
        from nasrec_tpu_torch.parallel.distributed import host_info

        rank, world = host_info()
        model = max(getattr(args, "mesh_model", 0), 1)
        data_size = world // model if world % model == 0 else world
        if num_hosts <= 0:
            num_hosts = data_size
        elif num_hosts != data_size:
            raise SystemExit(
                f"--num_hosts {num_hosts} does not match the mesh's data size "
                f"{data_size} ({world} processes, --mesh_model {model}); omit "
                "--num_hosts (it defaults to the data size) or launch that many "
                "data ranks")
        if host_id < 0:
            host_id = rank // model
        if train_bs % num_hosts or test_bs % num_hosts:
            raise SystemExit(f"batch sizes ({train_bs}/{test_bs}) must divide evenly "
                             f"across {num_hosts} hosts")
        if args.data_source != "synthetic":
            train_bs //= num_hosts
            test_bs //= num_hosts
    return DataOptions(
        dataset=args.dataset,
        root_dir=args.root_dir,
        data_source=args.data_source,
        train_split=args.train_split,
        validate_split=args.validate_split,
        train_batch_size=train_bs,
        test_batch_size=test_bs,
        vocab_cap=SEARCH_MAX_NUM_EMBEDDINGS if args.cap_vocab == 1 else None,
        synthetic_vocab=args.synthetic_vocab,
        host_id=max(host_id, 0),
        num_hosts=max(num_hosts, 1),
    )


def train_options(args) -> TrainOptions:
    return TrainOptions(
        learning_rate=args.learning_rate,
        wd=args.wd,
        optimizer=args.optimizer,
        lr_schedule=args.lr_schedule,
        num_epochs=args.num_epochs,
        train_limit=args.train_limit,
        test_limit=args.test_limit,
        display_interval=args.display_interval,
        test_interval=args.test_interval,
        max_train_steps=args.max_train_steps,
        max_eval_steps=args.max_eval_steps,
        test_only_at_last_step=args.test_only_at_last_step == 1,
        no_reg_param_name=args.no_reg_param_name,
        activation=args.activation,
        seed=args.seed,
        logging_dir=args.logging_dir,
        mesh_model=args.mesh_model,
        compute_dtype=args.compute_dtype,
        report_flops=args.report_flops == 1,
        profile_dir=args.profile_dir,
        attention_impl=args.attention_impl,
        place_embedding_on_cpu=args.place_embedding_on_cpu == 1,
        ckpt_backend=args.ckpt_backend,
        micro_batches=args.micro_batches,
        table_update=args.table_update,
        device=args.device,
    )
