#!/bin/bash
# Train the published best xlarge arch on avazu from scratch.
# Hyperparameters mirror the reference launcher
# (ref: nasrec/scripts/eval_best_model/eval_avazu_xlarge_best_1shot_models.sh).
# PyTorch/CUDA port of scripts/eval_best_model/avazu_xlarge.sh:
# the same flags, run by the nasrec_tpu_torch CLI on the card.
LR=0.2
WD=0

python -u -m nasrec_tpu_torch.cli.main_train \
    --root_dir ./data/avazu_kaggle_autoctr/ \
    --dataset avazu \
    --net supernet-config \
    --arch avazu/xlarge \
    --num_epochs 1 \
    --learning_rate $LR \
    --train_batch_size 256 \
    --wd $WD \
    --test_interval 10000 \
    --logging_dir ./experiments/best_models/avazu_xlarge_lr${LR}_wd${WD}
