from .stratified import KPConvEmbed, STBlock, StratifiedTransformer, WindowAttention
