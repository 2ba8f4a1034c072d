"""ao_tpu_torch and chip_smoke.py stand alone: they import neither JAX nor
ao_tpu (nor flax or optax), build no extension through
torch.utils.cpp_extension, and the smoke script's slice phase, train
phase (the hook-driven trainer, with its evaluation of a validation room
and its checkpoints) and AO phase (PP2S in oracle mode, a REAL run whose
epoch ends with a refinement round over oracle masks in a fork pool, and
the neural SAM's embeddings and decodes at SamConfig.tiny()) run end to
end (on the CPU, at a tiny size) with JAX and ao_tpu made unimportable."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
import importlib, pkgutil
import ao_tpu_torch
for m in pkgutil.walk_packages(ao_tpu_torch.__path__, "ao_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
res, votes, n_views = chip_smoke.run_slice(
    "cpu", 0, room_size=(1.0, 0.8, 0.5), views=1, pad_multiple=256)
chip_smoke.check_votes(votes, n_views)
rooms = [chip_smoke.make_room(s, (0.8, 0.7, 0.5)) for s in (1, 2, 3)]
_, options = chip_smoke.train_setup(rooms[:2], batch_size=2, max_steps=1,
                                    workers=0, val_room=rooms[2])
backbone = dict(patch_embed_channels=16, patch_embed_groups=2,
                enc_channels=(16, 32, 64), enc_groups=(2, 4, 8),
                dec_channels=(16, 16, 32), dec_groups=(2, 2, 4),
                enc_depths=(1, 1, 1), patch_embed_depth=1)
trainer = chip_smoke.run_train("cpu", options + [
    f"model.backbone={backbone!r}", "pad_multiple=512"])
chip_smoke.check_train(trainer, 1)
chip_smoke.check_val(trainer)
ao_rooms = [chip_smoke.make_room(s, (1.2, 1.0, 0.8), 0.05) for s in (1, 2, 3)]
workdir, options, seconds, labels = chip_smoke.real_setup(
    ao_rooms[:2], ao_rooms[2], size=64, views=2, batch_size=2, max_steps=1,
    workers=0, device="cpu")
real, record = chip_smoke.run_real("cpu", options + [
    f"model.backbone={backbone!r}", "pad_multiple=512",
    "real.refine_workers=2"])
chip_smoke.check_real(real, record, workdir + "/sam_labels")
sam = chip_smoke.run_sam(workdir, record["baskets"][0], "cpu",
                         model_type="tiny", size=64)
assert sam["masks"] > 0 and len(sam["set_image_ms"]) == 2
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("ISOLATED", res["scenes"][0]["fragments"], trainer.history[0]["loss"],
      real.refine_history[0]["num_updated"], sam["prompts"])
"""


def test_port_runs_without_jax_or_ao_tpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ISOLATED" in res.stdout


def test_port_sources_name_no_jax_no_ao_tpu_no_cpp_extension():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "ao_tpu_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    bad = re.compile(r"cpp_extension|import jax|from jax|ao_tpu\.|import ao_tpu\b"
                     r"|import flax|from flax|import optax|from optax"
                     r"|torch/extension\.h|import triton")
    names = {os.path.relpath(f, ROOT) for f in files}
    for src in ("gva_pos.cu", "gva_stats.cu", "gva_bwd.cu", "gva_tile.cuh"):
        assert f"ao_tpu_torch/csrc/{src}" in names
    for mod in ("engines/train.py", "tools/train.py", "models/losses/misc.py",
                "utils/optimizer.py", "utils/scheduler.py",
                "pp2s/projection.py", "pp2s/labels.py", "pp2s/pipeline.py",
                "models/sam/oracle.py", "models/sam/modeling.py",
                "models/sam/convert.py", "models/sam/predictor.py",
                "engines/label_eval.py", "engines/train_real.py",
                "utils/comm.py", "tools/pp2s.py", "tools/train_pp2s.py",
                "tools/train_real.py", "tools/evaluate_labels.py"):
        assert f"ao_tpu_torch/{mod}" in names
    hits = []
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                if bad.search(line):
                    hits.append(f"{os.path.relpath(f, ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_chip_smoke_refuses_to_run_without_a_card():
    """Off the card the script exits non-zero and prints no result."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
