"""Verify split-dataset integrity against the reference's published md5sums
(a copy of `nasrec_tpu/tools/verify_data.py`).

The reference pins shard-0 md5s for all three datasets (ref: README.md:33-58)
— those act as data-integrity oracles for the canonical 8-shard splits.

Usage:
  python -m nasrec_tpu_torch.tools.verify_data --dataset criteo-kaggle \
      --root_dir ./data/criteo_kaggle_autoctr
"""

from __future__ import annotations

import argparse
import hashlib
import os

# Published shard-0 md5s (ref: README.md:35-58).
PUBLISHED_MD5 = {
    "criteo-kaggle": {
        "test.txt": "5d8fea15e6f9c48a0a64b4a5bf971cc4",
        "train.txt": "4b8757a78fdb260f6ae9b72e05dca400",
        "trainval.txt": "acba0de85545c95a022d7c54aa9e8a8e",
        "val.txt": "91b0ff0a10d7a0cd2a6d59da9e5900b9",
    },
    "avazu": {
        "test.txt": "18bf7ba03d014d5661b9d8de1c0cbafe",
        "train.txt": "4cbec9323c975209b64a8403b2151ec7",
        "trainval.txt": "c47e4cba6b6945507ea754e2cf352578",
        "val.txt": "445bc4a44216c15c1b953523e0b0bc35",
    },
    "kdd": {
        "test.txt": "4cdfb93e36784d8e39ac00ac6e36a727",
        "train.txt": "eec7bb5bec894b42145cc9d0d0d624d0",
        "trainval.txt": "0d309f16f95bded40456f63735ee6534",
        "val.txt": "c44da6a57501b812cc55997893276a66",
    },
}

# Expected split sizes (ref: nasrec/main_train.py:354-359).
EXPECTED_ROWS = {
    "criteo-kaggle": {"train": 36_672_495, "val": 4_584_061, "test": 4_584_061},
    "avazu": {"train": 32_343_175, "val": 4_042_896, "test": 4_042_896},
    "kdd": {"train": 119_711_284, "val": 14_963_910, "test": 14_963_910},
}


def md5_file(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def verify(dataset: str, root_dir: str, log_fn=print) -> bool:
    ok = True
    for name, want in PUBLISHED_MD5[dataset].items():
        path = os.path.join(root_dir, "shard-0", name)
        if not os.path.exists(path):
            log_fn(f"MISSING  {path}")
            ok = False
            continue
        got = md5_file(path)
        status = "OK " if got == want else "BAD"
        if got != want:
            ok = False
        log_fn(f"{status} {path}  {got} (want {want})")
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   choices=["criteo-kaggle", "avazu", "kdd"])
    p.add_argument("--root_dir", required=True)
    args = p.parse_args(argv)
    ok = verify(args.dataset, args.root_dir)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
