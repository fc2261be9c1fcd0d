"""Export EA search results to best-arch choice JSONs (a copy of
`nasrec_tpu/tools/export_ea_results.py`; the same files for the same pickle).

Replaces the reference's notebooks/dump_ea_records.ipynb: sort the EA
results pickle by test_loss, dedup by arch hash, and dump the top-k as
reference-schema JSONs consumable by main_train --supernet_config.
"""

from __future__ import annotations

import argparse
import os
import pickle

from nasrec_tpu_torch.config import OPS_CONFIG_LIB
from nasrec_tpu_torch.choices import choice_to_json
from nasrec_tpu_torch.search.tokenizer import Tokenizer


def export_best(results, out_dir: str, config: str, num_blocks: int,
                use_layernorm: bool, top_k: int = 5, log_fn=print):
    tokenizer = Tokenizer(num_blocks, OPS_CONFIG_LIB[config])
    seen = set()
    ranked = sorted(results, key=lambda r: r["test_loss"])
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for r in ranked:
        h = tokenizer.hash_choice(r["choice"])
        if h in seen:
            continue
        seen.add(h)
        i = len(written)
        path = os.path.join(out_dir, f"best_config_{i}.json")
        with open(path, "w") as f:
            f.write(
                choice_to_json(
                    r["choice"], num_blocks=num_blocks, config_name=config,
                    use_layernorm=use_layernorm,
                    extra={"test_loss": float(r["test_loss"])},
                )
            )
        log_fn(f"{path}: test_loss={r['test_loss']:.6f}")
        written.append(path)
        if len(written) >= top_k:
            break
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results_pickle", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--config", default="xlarge")
    p.add_argument("--num_blocks", type=int, default=7)
    p.add_argument("--use_layernorm", type=int, default=1)
    p.add_argument("--top_k", type=int, default=5)
    args = p.parse_args(argv)
    with open(args.results_pickle, "rb") as f:
        results = pickle.load(f)
    export_best(results, args.out_dir, args.config, args.num_blocks,
                args.use_layernorm == 1, args.top_k)


if __name__ == "__main__":
    main()
