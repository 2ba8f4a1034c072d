"""The reference's side of the correctness checks, and the numbers compared.

Training: the reference takes the same initial weights and the same three
batches as the program's first three steps (the batches the program's
loader made), the same stochastic-depth draws (a generator seeded as the
program seeds its own), AdamW with the configuration's hyper-parameters and
its own schedule, and steps in float32. The numbers, each a relative gap:

* ``loss_gap.step<k>``: |loss_program - loss_reference| / |loss_reference|
  at step k;
* ``logit_gap.step1``: the norm of the gap between the two sides' logits
  of step 1's forward over the batch's valid points, over the norm of the
  reference's; ``logit_gap.step1.median``: the median point's gap (the
  norm over its classes) over the reference's root-mean-square point. A
  point the program gave no logits for reads its logits as 0;
* ``embed_gap.step1`` and ``embed_gap.step1.median``: the same of the
  patch embedding's output (the blocks at full resolution, before any
  pooling), which rounding alone moves: no pooled voxel or unpooling
  carries a changed last bit to other points there;
* ``grad_dir.median``: the median leaf's norm of the difference between
  the two first gradients, over the larger of the reference leaf's norm
  and the median leaf's: the gradient's direction as well as its size;
* ``grad_gap`` (the worst leaf) and ``grad_gap.median`` (the median leaf):
  the gap between the norms of a leaf's first gradient, the program's read
  from its optimizer's state after step 1 (AdamW's first moment over
  1 - beta1), over the larger of the reference leaf's norm and the median
  leaf's; ``grad_norm_gap``: the same of all leaves together;
* ``change_gap`` and ``change_gap.median``: the same for the parameters'
  change over the three steps, over the leaves whose reference gradient is
  at least a thousandth of the median leaf's (a leaf whose gradient is
  nought to rounding, as a bias before a BatchNorm, moves under AdamW by
  round-off alone).

A cell compares the numbers its limits file lists.
"""

from __future__ import annotations

import statistics

import torch

from .ptv2m2 import (ReferencePTv2, block_rates, cross_entropy, drop_keeps,
                     load_program_state, lr_schedule)


class FirstOutput:
    """A forward hook that keeps a module's first output (its tensor, or
    ``pick`` of it) on the host in float32."""

    def __init__(self, module, pick=lambda out: out):
        self.value, self._pick = None, pick
        self._hook = module.register_forward_hook(self)

    def __call__(self, module, inputs, out):
        if self.value is None:
            self.value = self._pick(out).detach().float().cpu()

    def remove(self):
        self._hook.remove()


def _median(values):
    return statistics.median(values) if values else 0.0


def leaf_gaps(prog, ref, names):
    """|prog - ref| / max(ref, median of ref) of each leaf of ``names``; a
    leaf the program has no reading for reads 0."""
    med = _median([ref[n] for n in ref])
    return [abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in names]


def _total(norms, names):
    return sum(norms.get(n, 0.0) ** 2 for n in names) ** 0.5


def reference_train(backbone, optimizer, scheduler, total_steps, weights,
                    batches, drop_seed, device, on_card, lowp=None,
                    half=False):
    """Losses of each step; step 1's logits, its patch embedding's output,
    its batch's mask and its gradient by leaf; the three steps' change's
    norm by leaf (names with the program's ``backbone.`` prefix; tensors on
    the host)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ReferencePTv2(backbone, lowp=lowp, on_card=on_card).to(device)
    load_program_state(ref, weights)
    ref.train()
    opt = torch.optim.AdamW(ref.parameters(), lr=optimizer["lr"],
                            betas=tuple(optimizer.get("betas", (0.9, 0.999))),
                            eps=optimizer.get("eps", 1e-8),
                            weight_decay=optimizer.get("weight_decay", 0.01))
    lr_at = lr_schedule(scheduler, optimizer["lr"], total_steps)
    gen = torch.Generator(device=device)
    gen.manual_seed(drop_seed)
    rates = block_rates(ref)
    start = {n: p.detach().clone() for n, p in ref.named_parameters()}
    losses, grads, logits1, mask1, embed = [], {}, None, None, None
    for k, batch in enumerate(batches):
        for g in opt.param_groups:
            g["lr"] = lr_at(k)
        coord, feat, mask, seg = (batch[x].to(device) for x in
                                  ("coord", "feat", "mask", "segment"))
        if half:  # the fault: half of the batch left out
            B = coord.shape[0] // 2
            coord, feat, mask, seg = coord[:B], feat[:B], mask[:B], seg[:B]
        if k == 0:
            hook = FirstOutput(ref.patch_embed.blocks, lambda out: out[0])
        logits = ref(coord, feat, mask,
                     keeps=drop_keeps(gen, rates, coord.shape[0], device))
        loss = cross_entropy(logits, seg.long(), mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if k == 0:
            hook.remove()
            embed = hook.value
            logits1 = logits.detach().float().cpu()
            mask1 = mask.cpu()
            grads = {"backbone." + n: p.grad.detach().float().cpu()
                     for n, p in ref.named_parameters() if p.grad is not None}
        opt.step()
        losses.append(float(loss.detach()))
        del logits, loss
    change = {"backbone." + n: float((p.detach() - start[n]).norm())
              for n, p in ref.named_parameters()}
    del ref, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=losses, grads=grads, change=change, logits=logits1,
                embed=embed, mask=mask1)


def output_gaps(prog, ref, mask):
    """(gap of all valid points' outputs, the median point's gap), each
    relative to the reference (see ``logit_gap`` in the module's
    docstring)."""
    p = torch.zeros_like(ref)
    if prog is not None:
        b, n = min(prog.shape[0], ref.shape[0]), min(prog.shape[1], ref.shape[1])
        p[:b, :n] = prog[:b, :n]
    r = ref[mask]
    d = (p[mask] - r).norm(dim=-1)
    scale = float(r.norm())
    rms = scale / max(r.shape[0], 1) ** 0.5
    return (float(d.norm()) / max(scale, 1e-30),
            float(d.median()) / max(rms, 1e-30))


def train_checks(prog, ref):
    """[(name, value)] of the numbers compared for a train cell."""
    out = [(f"loss_gap.step{k + 1}",
            abs(lp - lr) / max(abs(lr), 1e-30))
           for k, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"]))]
    for name, key in (("logit", "logits"), ("embed", "embed")):
        whole, point = output_gaps(prog[key], ref[key], ref["mask"])
        out += [(f"{name}_gap.step1", whole), (f"{name}_gap.step1.median", point)]
    names = sorted(ref["grads"])
    ref_norms = {n: float(ref["grads"][n].norm()) for n in names}
    prog_norms = {n: float(g.norm()) for n, g in prog["grads"].items()}
    g = leaf_gaps(prog_norms, ref_norms, names)
    total = _total(ref_norms, names)
    med = _median(list(ref_norms.values()))
    diff = {n: float((prog["grads"][n] - ref["grads"][n]).norm())
            if n in prog["grads"] else ref_norms[n] for n in names}
    out += [("grad_gap", max(g)), ("grad_gap.median", _median(g)),
            ("grad_norm_gap",
             abs(_total(prog_norms, names) - total) / max(total, 1e-30)),
            ("grad_dir.median", _median([diff[n] / max(ref_norms[n], med, 1e-30)
                                         for n in names]))]
    moved = [n for n in names if ref_norms[n] >= 1e-3 * med]
    c = leaf_gaps(prog["change"], ref["change"], moved)
    out += [("change_gap", max(c)), ("change_gap.median", _median(c))]
    return out
