from repro_torch.optim.adamw import (OptConfig, TRAINABLE_SUFFIXES,
                                     adamw_init, adamw_update,
                                     clip_by_global_norm, merge_params,
                                     partition_params, trainable_mask,
                                     tree_leaves, tree_map)
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                          ef_psum_int8)
from repro_torch.optim.schedules import make_schedule

__all__ = [
    "OptConfig", "TRAINABLE_SUFFIXES", "adamw_init", "adamw_update",
    "clip_by_global_norm", "merge_params", "partition_params",
    "trainable_mask", "make_schedule", "tree_leaves", "tree_map",
    "compress_int8", "decompress_int8", "ef_psum_int8",
]
