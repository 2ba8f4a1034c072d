from .projection import align_room, project_points, compute_bridge, render_depth_map
from .labels import (
    choose_weak_labels,
    make_basket,
    save_basket,
    load_basket,
    MaskVote,
    run_sam_labels_for_scene,
)
from .pipeline import PP2SPipeline
