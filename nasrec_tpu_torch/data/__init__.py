from nasrec_tpu_torch.data.cache import build_binary_cache, open_binary_cache
from nasrec_tpu_torch.data.pipeline import (
    batch_iterator,
    device_prefetch,
    make_dataset_iterators,
    prefetch,
    shard_paths,
)
from nasrec_tpu_torch.data.synthetic import (
    SyntheticSpec,
    synthetic_arrays,
    synthetic_batches,
)
from nasrec_tpu_torch.data.transforms import (
    TRANSFORMS,
    get_transform,
    transform_avazu,
    transform_criteo,
    transform_kdd,
)
