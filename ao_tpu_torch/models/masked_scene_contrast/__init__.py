from .msc import MaskedSceneContrast, cross_masks, match_pairs
