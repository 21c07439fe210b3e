"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint.manager``), and the train CLI's
``--ckpt-dir/--ckpt-every/--resume`` on the CPU.

Tolerances: none.  Checkpoints cross between the packages bit for bit in
both directions (bf16 leaves compared as their 16 bits), and a resumed
train run gives the losses and gradient norms of an unbroken one exactly:
the restored state, the data stream's position and every op are the same
on the CPU.
"""
import json
import os
import signal

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import restore_tree as jax_restore
from repro.checkpoint.manager import save_tree as jax_save
from repro_torch.checkpoint import (CheckpointManager, list_steps,
                                    restore_tree, save_tree)
from repro_torch.checkpoint import manager as tmanager
from repro_torch.launch import train as ttrain
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import names as t_names
from repro_torch.utils import tree_paths
from tests import torch_parity  # noqa: F401  (sets torch's threads)


def _numpy_tree(seed=0):
    """Leaves of every dtype a param tree holds, bf16 as ml_dtypes."""
    rng = np.random.default_rng(seed)
    return {"embed": {"w": rng.normal(size=(8, 4)).astype(ml_dtypes.bfloat16)},
            "blocks": {"attn": {"q": {
                "qcodes": rng.integers(0, 255, (3, 2, 5), dtype=np.uint8),
                "scales": rng.normal(size=(3, 1, 5)).astype(np.float32),
                "lora_a": rng.normal(size=(3, 4, 2)).astype(
                    ml_dtypes.bfloat16)}}},
            "opt": {"step": np.array(7, np.int32),
                    "stub": np.zeros((0,), np.float32)}}


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as numpy (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_bits(got: dict, want: dict) -> None:
    g, w = tree_paths(got), tree_paths(want)
    assert sorted(g) == sorted(w)
    for p in w:
        gb, wb = _bits(g[p]), _bits(w[p])
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, p
        np.testing.assert_array_equal(gb, wb, err_msg=p)


def test_jax_checkpoint_restores_bit_exact_in_the_port(tmp_path):
    tree = _numpy_tree()
    jax_save(tree, str(tmp_path), 3, extra_meta={"data": {"step": 5}})
    got, meta = restore_tree(str(tmp_path))
    assert got["embed"]["w"].dtype == torch.bfloat16
    assert got["blocks"]["attn"]["q"]["qcodes"].dtype == torch.uint8
    _same_bits(got, tree)
    assert meta["step"] == 3 and meta["data"] == {"step": 5}


def test_port_checkpoint_restores_bit_exact_in_jax(tmp_path):
    tree = _numpy_tree(1)
    port = {"embed": {"w": torch.from_numpy(
        tree["embed"]["w"].view(np.uint16).view(np.int16)).view(
            torch.bfloat16)},
        "blocks": {"attn": {"q": {
            k: (torch.from_numpy(v.view(np.uint16).view(np.int16)).view(
                torch.bfloat16) if v.dtype.name == "bfloat16"
                else torch.from_numpy(v))
            for k, v in tree["blocks"]["attn"]["q"].items()}}},
        "opt": {k: torch.from_numpy(v) for k, v in tree["opt"].items()}}
    save_tree(port, str(tmp_path), 4, extra_meta={"data": {"step": 2}})
    got, meta = jax_restore(str(tmp_path))
    assert got["embed"]["w"].dtype == jnp.bfloat16
    _same_bits(got, tree)
    assert meta["step"] == 4 and meta["data"] == {"step": 2}
    # the two packages write the same arrays and checksums
    jax_save(tree, str(tmp_path / "jax"), 4)
    with open(tmp_path / "step_00000004" / "meta.json") as f:
        mine = json.load(f)["checksums"]
    with open(tmp_path / "jax" / "step_00000004" / "meta.json") as f:
        theirs = json.load(f)["checksums"]
    assert mine == theirs


def test_restore_onto_a_device_and_background_save(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": torch.ones(2, dtype=torch.bfloat16)}
    t = save_tree(tree, str(tmp_path), 1, background=True)
    t.join()
    got, _ = restore_tree(str(tmp_path), 1, device="cpu")
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"],
                                                            tree["b"])


@pytest.mark.parametrize("leaf", ["blocks.attn.q.scales", "embed.w"])
def test_corrupted_leaf_raises_naming_it(tmp_path, leaf):
    """One leaf's stored array changed after the save: the restore fails
    its crc32 and names that leaf."""
    tree = _numpy_tree()
    save_tree(tree, str(tmp_path), 0)
    path = tmp_path / "step_00000000" / "arrays.npz"
    data = dict(np.load(path))
    key = next(k for k in data if k.split("__")[0] == leaf)
    data[key] = data[key].copy()
    data[key].view(np.uint8).flat[0] ^= 1
    np.savez(path, **data)
    with pytest.raises(ValueError, match=f"checksum mismatch for leaf "
                                         f"'{leaf}'"):
        restore_tree(str(tmp_path))


def test_truncated_shard_raises(tmp_path):
    save_tree(_numpy_tree(), str(tmp_path), 0)
    path = tmp_path / "step_00000000" / "arrays.npz"
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(ValueError, match="unreadable"):
        restore_tree(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        restore_tree(str(tmp_path / "none"))


def test_retention_keeps_newest_and_pinned(tmp_path):
    """keep=2: the two newest steps survive, and so does every pinned step
    however many saves follow; a step directory without meta.json (a torn
    write of an older layout) and the staging area are not steps."""
    m = CheckpointManager(str(tmp_path), keep=2, every=2, async_write=False)
    tree = {"x": torch.zeros(3)}
    saved = [s for s in range(1, 11) if m.maybe_save(s, tree,
                                                     pin=(s == 4))]
    assert saved == [2, 4, 6, 8, 10]
    assert m.maybe_save(11, tree, force=True)
    os.makedirs(tmp_path / "step_00000099")
    assert list_steps(str(tmp_path)) == [4, 10, 11]
    assert m.latest_step() == 11
    assert os.path.exists(tmp_path / "step_00000004" / tmanager.PIN_MARKER)
    before = t_metrics.counter(t_names.CKPT_RESTORES).value
    _, meta = m.restore(4)
    assert meta["step"] == 4
    assert t_metrics.counter(t_names.CKPT_RESTORES).value == before + 1


def test_async_manager_saves_in_the_background(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3, every=1, async_write=True)
    for s in range(1, 5):
        m.maybe_save(s, {"x": torch.full((4,), float(s))})
    m.wait()
    assert list_steps(str(tmp_path))[-1] == 4
    got, _ = m.restore()
    assert torch.equal(got["x"], torch.full((4,), 4.0))


TRAIN = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps",
         "4", "--batch", "2", "--seq-len", "16", "--calib-batches", "1",
         "--rank", "8", "--ckpt-every", "2"]


def _run(argv):
    return ttrain.run(ttrain.build_parser().parse_args(argv))


def test_train_resume_gives_the_unbroken_losses(tmp_path, monkeypatch):
    """A run stopped by SIGTERM after step 2 saves a pinned step there; a
    second run with --resume continues from it with the data stream where
    it stood, and its losses and gradient norms are the unbroken run's."""
    full = _run(TRAIN + ["--ckpt-dir", str(tmp_path / "full")])
    assert not full["preempted"] and full["ckpt_step"] == 4
    assert list_steps(str(tmp_path / "full")) == [2, 4]

    make = ttrain.make_train_step

    def stopping(*a, **kw):
        fn, calls = make(*a, **kw), [0]

        def step(state, batch):
            out = fn(state, batch)
            calls[0] += 1
            if calls[0] == 2:
                signal.raise_signal(signal.SIGTERM)
            return out
        return step

    monkeypatch.setattr(ttrain, "make_train_step", stopping)
    ck = str(tmp_path / "broken")
    cut = _run(TRAIN + ["--ckpt-dir", ck])
    monkeypatch.setattr(ttrain, "make_train_step", make)
    assert cut["preempted"] and cut["ckpt_step"] == 2
    assert os.path.exists(os.path.join(ck, "step_00000002",
                                       tmanager.PIN_MARKER))
    assert cut["losses"] == full["losses"][:2]
    rest = _run(TRAIN + ["--ckpt-dir", ck, "--resume"])
    assert rest["start_step"] == 2 and not rest["preempted"]
    assert rest["losses"] == full["losses"][2:]
    assert rest["grad_norms"] == full["grad_norms"][2:]
    final, meta = restore_tree(ck)
    ref, _ = restore_tree(str(tmp_path / "full"))
    _same_bits(final, ref)
    assert meta["step"] == 4 and meta["data"]["step"] == 1 + 4


def test_train_checkpoint_reads_in_jax(tmp_path):
    """The train CLI's checkpoint is the JAX package's format: JAX restores
    it, with the LoRA leaves under ``train.blocks`` and the data stream's
    state in the meta."""
    res = _run(TRAIN[:6] + ["2"] + TRAIN[7:] + ["--ckpt-dir",
                                                str(tmp_path)])
    tree, meta = jax_restore(str(tmp_path))
    assert meta["step"] == 2 and meta["data"] == {"step": 3, "seed": 0}
    port = tree_paths(res["state"])
    for p, leaf in tree_paths(tree).items():
        np.testing.assert_array_equal(_bits(leaf), _bits(port[p]),
                                      err_msg=p)
    assert "train.blocks.attn.q.lora_a" in tree_paths(tree)


# ---------------------------------------------------------------------------
# The quantization journal (resumable batched quantization).
# ---------------------------------------------------------------------------


def _quant_setup():
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models.modules import QSpec
    from repro_torch.models.transformer import init_params
    cfg = get_smoke_config("qwen3-1.7b")
    params = init_params(cfg, seed=0, device="cpu")
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=2, seed=0))
    calib = [stream.next_batch() for _ in range(2)]
    recipe = QuantRecipe.single("cloq", QSpec(bits=4, group_size=16, rank=4))
    return cfg, params, calib, recipe


def _quantize(**kw):
    from repro_torch.core.pipeline import quantize_model
    cfg, params, calib, recipe = _quant_setup()
    recipe = kw.pop("recipe", recipe)
    qp, _, _ = quantize_model(params, cfg, calib, recipe=recipe, **kw)
    return qp


@pytest.mark.fault
def test_journal_preempt_resume_bit_identical(tmp_path):
    """``should_stop`` at the first bucket boundary raises QuantPreempted
    with bucket 0 committed; the rerun restores it and gives the tree of
    an uninterrupted run bit for bit; the health report lands in the
    journal directory."""
    from repro_torch.core.health import HealthReport, QuantPreempted
    jd = str(tmp_path / "journal")
    with pytest.raises(QuantPreempted) as ei:
        _quantize(journal_dir=jd, should_stop=lambda: True)
    assert ei.value.bucket == 0
    assert tmanager.QuantJournal(jd).buckets() == [0]
    restored = t_metrics.counter(t_names.JOURNAL_RESTORED)
    before = restored.value
    report = HealthReport()
    resumed = _quantize(journal_dir=jd, report=report)
    assert restored.value - before == 1
    assert any("restored from journal" in e for e in report.events)
    assert tmanager.QuantJournal(jd).buckets() == [0, 1, 2, 3]
    with open(os.path.join(jd, "health.json")) as f:
        assert json.load(f)["checked"] == 14 - 4     # bucket 0 restored
    _same_bits(resumed, _quantize())


@pytest.mark.fault
def test_stale_or_foreign_journal_is_recomputed(tmp_path):
    """Entries from another plan (here another rank) or a torn entry are
    ignored and their buckets recomputed; the result is a fresh run's."""
    from repro_torch.core import faults
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models.modules import QSpec
    jd = str(tmp_path / "journal")
    _quantize(journal_dir=jd, recipe=QuantRecipe.single(
        "cloq", QSpec(bits=4, group_size=16, rank=8)))
    restored = t_metrics.counter(t_names.JOURNAL_RESTORED)
    before = restored.value
    _same_bits(_quantize(journal_dir=jd), _quantize())
    assert restored.value == before
    faults.truncate_file(os.path.join(jd, "step_00000002", "arrays.npz"))
    journal = tmanager.QuantJournal(jd)
    assert journal.load_bucket(2, {}, []) is None
    before = restored.value
    _same_bits(_quantize(journal_dir=jd), _quantize())
    assert restored.value - before == 3        # buckets 0, 1 and 3


@pytest.mark.fault
def test_journal_format_is_the_references(tmp_path):
    """A bucket the port commits is read by the JAX package's journal under
    the same fingerprint (the spec as the JAX planner resolves it), leaves
    bit-equal."""
    import dataclasses

    from repro.checkpoint.manager import QuantJournal as JaxJournal
    from repro.core.batched import make_spec as jax_make_spec
    from repro.models.modules import QSpec as JQSpec
    jd = str(tmp_path / "journal")
    _quantize(journal_dir=jd)
    meta = json.load(open(os.path.join(jd, "step_00000000", "meta.json")))
    ids = [["blocks.0.attn.k", None], ["blocks.0.attn.v", None],
           ["blocks.1.attn.k", None], ["blocks.1.attn.v", None]]
    spec = dataclasses.asdict(jax_make_spec(
        64, 32, JQSpec(bits=4, group_size=16, rank=4), "cloq", True))
    got = JaxJournal(jd).load_bucket(0, spec, ids)
    assert got is not None and meta["dense"] == []
    mine = tmanager.QuantJournal(jd).load_bucket(0, spec, ids)
    for a, b in zip(got[0], mine[0]):
        _same_bits(b, a)


@pytest.mark.fault
def test_shard_truncate_injection_point(tmp_path):
    """``shard_truncate`` tears the shard through ``save_tree``'s own
    post-commit hook, targeted by step."""
    from repro_torch.core import faults
    with faults.inject("shard_truncate", match="1"):
        save_tree(_numpy_tree(), str(tmp_path), 1)
        save_tree(_numpy_tree(), str(tmp_path), 2)
    with pytest.raises(ValueError, match="truncated|corrupt"):
        restore_tree(str(tmp_path), 1)
    _same_bits(restore_tree(str(tmp_path), 2)[0], _numpy_tree())


SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.mark.fault
def test_kill_between_buckets_then_resume(tmp_path):
    """SIGKILL right after bucket 1's journal commit kills the train CLI
    mid-quantization; buckets 0 and 1 survive, and a rerun with the same
    ``--resume-quant`` ends with the final loss of an uninterrupted run in
    a fresh journal."""
    import subprocess
    import sys
    jd = str(tmp_path / "journal")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-1.7b", "--smoke", "--device", "cpu", "--method", "cloq",
            "--bits", "4", "--group-size", "16", "--rank", "4", "--steps",
            "3", "--seq-len", "32", "--batch", "2", "--calib-batches", "1",
            "--resume-quant", jd]
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    killed = subprocess.run(
        args, env=dict(env, REPRO_FAULTS="kill_between_buckets=1"),
        capture_output=True, text=True, timeout=300)
    assert killed.returncode == -signal.SIGKILL, killed.stdout + \
        killed.stderr
    assert tmanager.QuantJournal(jd).buckets() == [0, 1]
    resumed = subprocess.run(args, env=env, capture_output=True, text=True,
                             timeout=300)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    fresh_args = list(args)
    fresh_args[-1] = str(tmp_path / "fresh")
    fresh = subprocess.run(fresh_args, env=env, capture_output=True,
                           text=True, timeout=300)
    assert fresh.returncode == 0, fresh.stdout + fresh.stderr

    def final_loss(out):
        line = [ln for ln in out.splitlines() if ln.startswith("[done]")][-1]
        return json.loads(line[len("[done]"):].strip())["final_loss"]

    assert final_loss(resumed.stdout) == final_loss(fresh.stdout)
