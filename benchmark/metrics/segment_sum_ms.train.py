"""CUDA-event ms of the port's duplicate-row segment-sum
(`train/sparse_embedding.py :: rowwise_segment_sum_slotwise`) on one of the
cell's batches of fused rows and a stem gradient of its shape."""

from lib import readers


def read(ctx):
    rows = ctx.get("fused_rows")
    if rows is None or rows.device.type != "cuda":
        return None
    import torch

    from nasrec_tpu_torch.train.sparse_embedding import rowwise_segment_sum_slotwise

    g = torch.randn(rows.numel(), 16, device=rows.device)
    return readers.cuda_ms(lambda: rowwise_segment_sum_slotwise(rows, g))
