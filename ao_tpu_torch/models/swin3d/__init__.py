from .swin3d import Swin3D, SwinBlockCRSE, WindowAttentionCRSE
