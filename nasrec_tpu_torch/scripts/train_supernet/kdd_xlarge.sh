#!/bin/bash
# One-shot supernet training on kdd (NASRec-Full space).
# Hyperparameters mirror the reference launcher
# (ref: nasrec/scripts/train_supernet/train_supernet_xlarge_kdd.sh).
# PyTorch/CUDA port of scripts/train_supernet/kdd_xlarge.sh:
# the same flags, run by the nasrec_tpu_torch CLI on the card.
LR=0.12
WD=0

python -u -m nasrec_tpu_torch.cli.train_supernet \
    --root_dir ./data/kdd_kaggle_autoctr \
    --dataset kdd \
    --learning_rate $LR \
    --train_batch_size 512 \
    --strategy default \
    --anypath_choice binomial-0.5 \
    --test_batch_size 4096 \
    --use_layernorm 1 \
    --supernet_training_steps 15000 \
    --config xlarge \
    --num_blocks 7 \
    --num_epochs 1 \
    --test_interval 2000 \
    --cap_vocab 1 \
    --wd $WD \
    --logging_dir ./experiments/supernet/kdd_xlarge_lr${LR}
