from .ptv1 import (
    PointTransformerCls,
    PointTransformerPartSeg,
    PointTransformerSeg,
)
