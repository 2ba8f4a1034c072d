from .cac import CACSegmentor, cac_distill_loss
