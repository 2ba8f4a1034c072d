"""Hook lifecycle base (port of ao_tpu/engines/hooks/default.py; reference:
pointcept/engines/hooks/default.py:1-32)."""


class HookBase:
    """Hooks observe and extend the trainer through its lifecycle:
    before_train, before_epoch, before_step, after_step, after_epoch,
    after_train. ``self.trainer`` is attached by the trainer when it
    registers the hook."""

    trainer = None

    def before_train(self):
        pass

    def before_epoch(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def after_epoch(self):
        pass

    def after_train(self):
        pass
