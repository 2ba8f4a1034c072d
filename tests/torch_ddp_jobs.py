"""Jobs of tests/test_torch_ddp.py, each run in a child process of the test
under its own ``timeout`` (a hang fails instead of stalling the run):

    python tests/torch_ddp_jobs.py units <out>
    python tests/torch_ddp_jobs.py runs <out> <runs.json>

``units``: two gloo processes started by ao_tpu_torch's launcher check the
comm helpers, the train sampler's shards, REAL's basket gather, and run
one train-mode GVA (the kernels' plain versions in float64, and the
unfused reference), PointBatchNorm and each loss (the Lovasz loss on
unequal point counts) on one scene each,
writing what each process computed to ``<out>/units<rank>.pt`` (the test
holds it against one process on both scenes). ``runs``: the recorded
runs of chip_smoke.run_recorded and the entry points that runs.json
lists, in this order. Every process pins one intra-op thread.
"""

import json
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

PNAMES = ("Wp1", "bp1", "gp", "bp", "Wp2", "bp2", "W1", "b1", "gw", "bw",
          "W2", "b2")


def gva_case(B=2, N=40, S=8, C=16, G=4, seed=7):
    """A small train-mode GVA case in float64: k, v, q (B, N, C), packed
    coordinates, neighbour ids and validity, a query mask, the raw
    parameters, running statistics and head weights."""
    rng = np.random.default_rng(seed)
    c = dict(k=rng.normal(size=(B, N, C)) * 0.5, v=rng.normal(size=(B, N, C)) * 0.5,
             q=rng.normal(size=(B, N, C)) * 0.5, coord=rng.uniform(0, 4, (B, N, 3)),
             idx=rng.integers(0, N, (B, N, S)), valid=rng.random((B, N, S)) < 0.9,
             mask=rng.random((B, N)) < 0.9, cw=rng.normal(size=G))
    c["valid"] &= c["mask"][..., None]
    p = dict(Wp1=((3, C), 0.3), bp1=((C,), 0.1), Wp2=((C, C), 0.2),
             bp2=((C,), 0.1), W1=((C, G), 0.3), b1=((G,), 0.1),
             W2=((G, G), 0.4), b2=((G,), 0.1))
    c["p"] = {k: rng.normal(size=s) * m for k, (s, m) in p.items()}
    c["p"].update(gp=np.full(C, 1.1), bp=np.full(C, 0.05), gw=np.full(G, 0.9),
                  bw=np.full(G, -0.02), pe_mean=np.zeros(C), pe_var=np.ones(C),
                  we_mean=np.zeros(G), we_var=np.ones(G))
    c["x"] = rng.normal(size=(B, N, C)) * 2 + 1  # PointBatchNorm's input
    c["logits"] = rng.normal(size=(B, N, 5))
    c["target"] = np.where(rng.random((B, N)) < 0.1, -1, rng.integers(0, 5, (B, N)))
    return c


def gva_grads(c, rows, world=1):
    """Per function of the train-mode GVA on scenes ``rows`` of the case:
    the outputs and the gradients of a head (sum sin(out) plus a linear
    term of the weight-BN statistics, its share of it under ``world``
    processes) with respect to the inputs and the parameters. ``kernels``:
    gva_train (K4, K5, K3 and K6's plain versions, float64, where they
    evaluate the exact algebra); ``reference``: gva_reference (autograd,
    float32, as the model runs it)."""
    from ao_tpu_torch.ops import gva as tg

    idx = torch.tensor(c["idx"][rows], dtype=torch.int32)
    valid = torch.tensor(c["valid"][rows])
    mask = torch.tensor(c["mask"][rows])
    out = {}
    for name, f64 in (("kernels", torch.float64), ("reference", torch.float32)):
        t = {k: torch.tensor(c[k][rows], dtype=f64)
             for k in ("k", "v", "q", "coord")}
        cw = torch.tensor(c["cw"], dtype=f64)
        ins = [t[k].clone().requires_grad_(True) for k in ("k", "v", "q")]
        p = {n: torch.tensor(v, dtype=f64).requires_grad_(n in PNAMES)
             for n, v in c["p"].items()}
        c6 = tg.pack_coords(t["coord"].double()).to(f64)
        if name == "kernels":
            src = torch.cat([ins[0], ins[1], c6], -1)
            qrow = torch.cat([ins[2], c6, mask[..., None].to(f64)], -1)
            y, (mu, var, n), (mu_p, var_p, n_p), _ = tg.gva_train(
                src, qrow, idx, valid, p)
        else:
            y, (mu, var, n), (mu_p, var_p, n_p) = tg.gva_reference(
                ins[0], ins[1], ins[2], c6, idx.long(), valid, mask, p, f64,
                train=True)
        head = (torch.sin(y).sum()
                + ((mu * cw).sum() + (var * cw * 0.5).sum()) / world)
        grads = torch.autograd.grad(head, ins + [p[n] for n in PNAMES])
        out[name] = dict(out=y.detach(), mu=mu.detach(), var=var.detach(),
                         n=float(n), mu_p=mu_p.detach(), var_p=var_p.detach(),
                         grads=[g.detach() for g in grads])
    return out


def bn_and_losses(c, rows):
    """PointBatchNorm (train mode, masked; it computes in float32) on
    scenes ``rows``:
    its output, running statistics and the gradients of sum sin(out); and
    each per-point loss's value and logits gradient."""
    from ao_tpu_torch.models import build_criteria
    from ao_tpu_torch.models.utils import PointBatchNorm
    from ao_tpu_torch.utils import comm

    bn = PointBatchNorm(c["x"].shape[-1]).train()
    x = torch.tensor(c["x"][rows], dtype=torch.float32, requires_grad=True)
    mask = torch.tensor(c["mask"][rows])
    y = bn(x, mask)
    gx, gw, gb = torch.autograd.grad(torch.sin(y).sum(),
                                     [x, bn.norm.weight, bn.norm.bias])
    out = dict(y=y.detach(), gx=gx, gw=gw, gb=gb,
               running_mean=bn.norm.running_mean.clone(),
               running_var=bn.norm.running_var.clone())
    logits = torch.tensor(c["logits"][rows], dtype=torch.float32)
    target = torch.tensor(c["target"][rows])
    for loss in (dict(type="CrossEntropyLoss", ignore_index=-1),
                 dict(type="CrossEntropyLoss", ignore_index=-1,
                      weight=[1.0, 2.0, 0.5, 1.5, 1.0]),
                 dict(type="SmoothCELoss"), dict(type="FocalLoss"),
                 dict(type="DiceLoss")):
        lg = logits.clone().requires_grad_(True)
        with comm.global_batch():  # as in the trainer's step
            value = build_criteria([loss])(lg, target, mask)
        (g,) = torch.autograd.grad(value, [lg])
        out[repr(loss)] = (float(value.detach()), g)
    return out


# the points of each scene of gva_case that the Lovasz check keeps: unequal
# counts, so that the gather pads the shorter process's errors
LOVASZ_POINTS = (40, 33)


def lovasz(c, rows):
    """LovaszLoss (its weight 0.7, ignore -1, the case's mask) on the first
    LOVASZ_POINTS points of each of the scenes ``rows``, concatenated:
    its value inside ``comm.global_batch()`` (as in the trainer's step)
    and its logits gradient."""
    from ao_tpu_torch.models.losses.lovasz import LovaszLoss
    from ao_tpu_torch.utils import comm

    take = lambda a: np.concatenate([a[r, :LOVASZ_POINTS[r]] for r in rows])  # noqa: E731
    logits = torch.tensor(take(c["logits"]), dtype=torch.float32,
                          requires_grad=True)
    with comm.global_batch():
        value = LovaszLoss(loss_weight=0.7, ignore_index=-1)(
            logits, torch.tensor(take(c["target"])), torch.tensor(take(c["mask"])))
    (g,) = torch.autograd.grad(value, [logits])
    return float(value.detach()), g


def units_worker(out):
    from ao_tpu_torch.engines.train import train_sampler
    from ao_tpu_torch.engines.train_real import merge_baskets
    from ao_tpu_torch.utils import comm

    rank, world = comm.get_rank(), comm.get_world_size()
    res = dict(world=world, rank=rank, local_rank=comm.get_local_rank(),
               main=comm.is_main_process())
    res["all_gather"] = comm.all_gather({"rank": rank, "s": "x" * rank})
    res["gather"] = comm.gather(rank * 10)
    res["seed"] = comm.shared_random_seed()
    res["reduce_mean"] = comm.reduce_dict({"a": float(rank), "b": 2.0})
    res["reduce_sum"] = comm.reduce_dict({"a": float(rank)}, average=False)
    res["all_reduce"] = comm.all_reduce(torch.tensor([1.0, rank])).tolist()
    x = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
    y = comm.all_reduce_grad(x)
    (g,) = torch.autograd.grad((y * torch.tensor([1.0, 3.0 + rank])).sum(), [x])
    res["all_reduce_grad"] = (y.detach().tolist(), g.tolist())
    t = torch.full((3,), float(rank))
    i = torch.full((2,), rank, dtype=torch.int64)
    comm.broadcast_([t, i])
    res["broadcast"] = (t.tolist(), i.tolist())
    comm.synchronize()
    sampler = train_sampler(range(11), world, rank, seed=5)
    res["sampler"] = []
    for epoch in range(3):
        sampler.set_epoch(epoch)
        res["sampler"].append(list(sampler))
    # REAL's basket: each process fills its own rows of the two scenes
    basket = {s: np.full((6, 3), -100.0, np.float32) for s in ("a/r0", "b/r1")}
    basket["a/r0"][rank::2] = rank + 1.0
    basket["b/r1"][rank] = 5.0 + rank
    merged = comm.gather(basket)
    res["basket"] = merge_baskets(basket, merged[1:]) if rank == 0 else None
    c = gva_case()
    res["gva"] = gva_grads(c, [rank], world)
    res["bn"] = bn_and_losses(c, [rank])
    comm.reset_counts()
    res["lovasz"] = lovasz(c, [rank])
    res["lovasz_collectives"] = comm.COUNTS["collectives"]
    comm.reset_counts()
    gva_grads(c, [rank], world)
    res["gva_collectives"] = comm.COUNTS["collectives"]
    torch.save(res, os.path.join(out, f"units{rank}.pt"))


def main():
    job, out = sys.argv[1], sys.argv[2]
    from ao_tpu_torch.engines import launch

    if job == "units":
        launch(units_worker, num_devices_per_machine=2, cfg=(out,),
               device="cpu")
        return
    import chip_smoke

    with open(sys.argv[3]) as f:
        runs = json.load(f)
    for run in runs:
        if run["kind"] == "recorded":
            chip_smoke.run_recorded(run["options"], run["world"],
                                    os.path.join(out, run["name"]),
                                    device="cpu", config=run["config"])
        else:  # an entry point of ao_tpu_torch.tools, as its command line
            import importlib

            importlib.import_module(
                f"ao_tpu_torch.tools.{run['kind']}").main(run["argv"])


if __name__ == "__main__":
    main()
