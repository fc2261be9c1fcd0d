"""CLI: convert TSV shards into the binary memory-mapped cache (a copy of
`nasrec_tpu/tools/build_cache.py`; the JAX package opens the files it writes).

  python -m nasrec_tpu_torch.tools.build_cache --dataset criteo-kaggle \
      --root_dir ./data/criteo_kaggle_autoctr --split trainval \
      --out_dir ./cache [--cap_vocab 1]
"""

from __future__ import annotations

import argparse
import time

from nasrec_tpu_torch.config import SEARCH_MAX_NUM_EMBEDDINGS
from nasrec_tpu_torch.data.cache import build_binary_cache


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True,
                   choices=["criteo-kaggle", "avazu", "kdd"])
    p.add_argument("--root_dir", required=True)
    p.add_argument("--split", default="trainval",
                   choices=["train", "val", "test", "trainval"])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--cap_vocab", type=int, default=0)
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--num_hosts", type=int, default=1)
    args = p.parse_args(argv)
    t0 = time.time()
    prefix = build_binary_cache(
        args.dataset, args.root_dir, args.split, args.out_dir,
        vocab_cap=SEARCH_MAX_NUM_EMBEDDINGS if args.cap_vocab else None,
        host_id=args.host_id, num_hosts=args.num_hosts,
    )
    print(f"cache written: {prefix} ({time.time() - t0:.1f}s)")
    return prefix


if __name__ == "__main__":
    main()
