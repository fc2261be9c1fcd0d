#!/bin/bash
# Train and rank the top-k EA-discovered archs on the validation split: the
# PyTorch/CUDA port's counterpart of
# scripts/eval_best_candidate/eval_best_candidates_topk.py, with its flags, e.g.
#   eval_best_candidates_topk.sh --ea_dir ./experiments/ea/criteo_xlarge/export \
#       --dataset criteo-kaggle --root_dir ./data/criteo_kaggle_autoctr --top_k 15
python -u -m nasrec_tpu_torch.tools.eval_best_candidates_topk "$@"
