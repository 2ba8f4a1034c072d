from .octformer import OctFormer, OctFormerBlock, OctreeAttention
