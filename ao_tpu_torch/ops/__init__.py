from .knn import knn, knn_query
from .knn_spatial import (
    knn_cross_spatial,
    knn_self_presorted,
    knn_self_spatial,
    knn_window,
    merge_topk,
    morton_code,
)
from .grouping import grouping, grouping_with_rel_coord
from .grid_pool import grid_pool, unpool_map
from .interpolation import interpolation
from .gva import gva_eval, pack_coords
from .sampling import farthest_point_sampling
from .window_partition import pack_windows, window_ids
