#!/bin/bash
# Train the published best xlarge arch on kdd from scratch.
# Hyperparameters mirror the reference launcher
# (ref: nasrec/scripts/eval_best_model/eval_kdd_xlarge_best_1shot_models.sh).
# PyTorch/CUDA port of scripts/eval_best_model/kdd_xlarge.sh:
# the same flags, run by the nasrec_tpu_torch CLI on the card.
LR=0.16
WD=0

python -u -m nasrec_tpu_torch.cli.main_train \
    --root_dir ./data/kdd_kaggle_autoctr/ \
    --dataset kdd \
    --net supernet-config \
    --arch kdd/xlarge \
    --num_epochs 1 \
    --learning_rate $LR \
    --train_batch_size 512 \
    --wd $WD \
    --test_interval 20000 \
    --logging_dir ./experiments/best_models/kdd_xlarge_lr${LR}_wd${WD}
