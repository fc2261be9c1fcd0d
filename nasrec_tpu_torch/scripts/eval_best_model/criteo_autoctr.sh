#!/bin/bash
# Train the published best autoctr arch on criteo-kaggle from scratch.
# Hyperparameters mirror the reference launcher
# (ref: nasrec/scripts/eval_best_model/eval_criteo_autoctr_best_1shot_models.sh).
# PyTorch/CUDA port of scripts/eval_best_model/criteo_autoctr.sh:
# the same flags, run by the nasrec_tpu_torch CLI on the card.
LR=0.1
WD=0

python -u -m nasrec_tpu_torch.cli.main_train \
    --root_dir ./data/criteo_kaggle_autoctr/ \
    --dataset criteo-kaggle \
    --net supernet-config \
    --arch criteo-kaggle/autoctr \
    --num_epochs 1 \
    --learning_rate $LR \
    --train_batch_size 256 \
    --wd $WD \
    --test_interval 10000 \
    --logging_dir ./experiments/best_models/criteo_autoctr_lr${LR}_wd${WD}
