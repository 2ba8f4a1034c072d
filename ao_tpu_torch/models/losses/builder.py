"""Loss registry and the Criteria sum (port of
ao_tpu/models/losses/builder.py)."""

from ...utils.registry import Registry

LOSSES = Registry("losses")


class Criteria:
    """Sums the configured losses; called as criteria(pred, target, mask)."""

    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.criteria = [LOSSES.build(dict(c)) for c in self.cfg]

    def __call__(self, pred, target, mask=None):
        if not self.criteria:
            return pred
        loss = 0.0
        for crit in self.criteria:
            loss = loss + crit(pred, target, mask)
        return loss


def build_criteria(cfg):
    return Criteria(cfg)
