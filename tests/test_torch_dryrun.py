"""Port parity: the dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

The port's dry run runs one rank's step on meta tensors over torch's fake
process group (256 ranks for the 16 x 16 production mesh, 512 for 2 x 16
x 16), in this process.  Its per-rank ``argument_bytes`` are held
against the bytes of JAX's own abstract shapes (``repro.launch.steps.
abstract_state``/``abstract_params``/``abstract_cache``/``batch_specs``)
under JAX's ``param_specs``/``state_pspecs``/``cache_specs``/
``batch_pspecs`` on a mesh stub (names and sizes, no devices, nothing
compiled), exactly; and, once, against XLA's own
``memory_analysis().argument_size_in_bytes`` of the JAX dry run compiled
on fake devices in a subprocess.  Depth 1 (an enc-dec model's encoder
too) throughout, as the dry run's depth probes.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import configs as jc
from repro.launch import shardings as jsh
from repro.launch import steps as jsteps
from repro.models.modules import QSpec as JQSpec
from repro.optim import OptConfig as JOptConfig
from repro_torch import configs as tc
from repro_torch.launch import dryrun
from tests import torch_parity  # noqa: F401  (sets torch's threads)
from tests.util import SRC, run_with_devices

ARCHS = [a for a, _ in sorted(tc.ALIASES.items(),
                              key=lambda kv: tc.ARCH_IDS.index(kv[1]))]
CELLS = list(jsteps.SHAPE_CELLS)
SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
# the archs whose KV heads the production model axis (16) does not divide:
# their decode cache is sharded along its sequence
SEQ_KV = {"qwen3-1.7b": 8, "qwen3-4b": 8, "qwen3-moe-30b-a3b": 4,
          "pixtral-12b": 8, "minicpm-2b": 36}


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The dry run makes the default group torch's fake one; it is taken
    down after this file, so that no later test in the process finds it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


class _MeshStub:
    """A mesh with axis names and sizes and no devices (both packages'
    layout rules read only these)."""

    def __init__(self, sizes: dict):
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self.shape = dict(sizes)


def _jax_cfg(arch: str):
    kw = {"quant": JQSpec(bits=4, group_size=64, rank=64), "n_layers": 1}
    if jc.get_config(arch).family == "encdec":
        kw["n_enc_layers"] = 1
    return jc.get_config(arch, **kw)


def _leaf_bytes(leaf, spec, sizes: dict) -> int:
    spec = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
    n = 1
    for dim, ax in zip(leaf.shape, spec):
        k = 1
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else tuple(ax)):
            k *= sizes[a]
        assert dim % k == 0, (leaf.shape, spec)
        n *= dim // k
    return n * np.dtype(leaf.dtype).itemsize


def _tree_bytes(shapes, specs, sizes: dict) -> int:
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs,
                                  is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_leaf_bytes(a, s, sizes) for a, s in zip(leaves, spec_leaves))


def jax_argument_bytes(arch: str, cell: str, sizes: dict) -> int:
    """A rank's bytes of the JAX dry run's step arguments for ``cell``:
    its abstract shapes under its layouts on a mesh of ``sizes``."""
    cfg = _jax_cfg(arch)
    stub = _MeshStub(sizes)
    da = ("pod", "data") if "pod" in sizes else "data"
    c = jsteps.SHAPE_CELLS[cell]
    batch = (jsteps.batch_specs(cfg, cell), jsteps.batch_pspecs(cfg, cell,
                                                                da))
    if c["kind"] == "train":
        st = jsteps.abstract_state(cfg, JOptConfig(total_steps=1000))
        args = [(st, jsteps.state_pspecs(st, stub)), batch]
    elif c["kind"] == "prefill":
        ps = jsteps.abstract_params(cfg)
        args = [(ps, jsh.param_specs(ps, stub)), batch]
    else:
        ps = jsteps.abstract_params(cfg)
        cache = jsteps.abstract_cache(cfg, cell)
        tokens = jax.ShapeDtypeStruct((c["batch"], 1), jnp.int32)
        args = [(ps, jsh.param_specs(ps, stub)),
                (cache, jsh.cache_specs(cfg, cache, stub, da)),
                (tokens, P(da if c["batch"] > 1 else None, None))]
    return sum(_tree_bytes(a, s, sizes) for a, s in args)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_cell_runs_with_jax_argument_bytes(arch, cell):
    """Every arch x cell on the single-pod mesh at depth 1 runs one rank's
    step on meta tensors, or skips with the JAX dry run's reason; a rank's
    argument bytes are those of JAX's abstract shapes under JAX's
    layouts, and the record holds the dry run's keys (no XLA cost)."""
    ok, why = jsteps.cell_applicable(_jax_cfg(arch), cell)
    res = dryrun.lower_cell(arch, cell, depth=1, verbose=False)
    if not ok:
        assert res["skipped"] and res["reason"] == why
        return
    assert res["mesh"] == "16x16" and res["n_chips"] == 256
    assert "cost" not in res
    mem = res["memory"]
    assert mem["argument_bytes"] == jax_argument_bytes(arch, cell, SINGLE)
    assert mem["output_bytes"] > 0 and mem["peak_bytes"] > 0
    assert res["collectives"]["n_ops"] > 0


@pytest.mark.parametrize("arch", sorted(SEQ_KV))
def test_decode_32k_takes_the_sequence_sharded_branch(arch):
    """decode_32k on the 16 x 16 mesh of the five archs whose KV heads 16
    does not divide: ``cache_specs`` shards the cache's sequence (a rank's
    K shard (L, 8, 2048, Hkv, hd): 8 of 128 rows, 2048 of 32768
    positions, every KV head), and the decode runs through it, gathering
    each rank's q/k/v columns to whole heads."""
    cfg = tc.get_config(arch)
    res = dryrun.lower_cell(arch, "decode_32k", depth=1, verbose=False)
    kv = res["kv_shard"]
    assert kv["sequence_sharded"] and kv["model_dim"] == 2
    assert kv["local"] == [1, 8, 2048, SEQ_KV[arch], cfg.head_dim]
    assert res["collectives"]["calls"]["all_gather"] >= 3


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in SEQ_KV and
                                  tc.get_config(a).family in
                                  ("dense", "moe", "encdec")])
def test_decode_32k_shards_kv_heads_where_16_divides_them(arch):
    """The other attention archs keep their KV heads sharded over "model"
    on the same cell."""
    res = dryrun.lower_cell(arch, "decode_32k", depth=1, verbose=False)
    assert res["kv_shard"]["model_dim"] == 3
    assert not res["kv_shard"]["sequence_sharded"]


SMOKE_FAMILIES = ["qwen3-1.7b", "mamba2-370m", "zamba2-7b",
                  "seamless-m4t-medium", "pixtral-12b"]


@pytest.mark.parametrize("arch", SMOKE_FAMILIES)
def test_dry_run_counts_chip_smokes_collectives(arch):
    """On a fake (data 2, model 2) group the dry run's train step of a
    smoke model issues the collectives ``chip_smoke.predicted_collectives``
    counts, the count the card's ``train_sharded`` phase holds and real
    gloo ranks pin (``test_chip_smoke_predicts_the_collectives``)."""
    sys.path.insert(0, str(os.path.dirname(SRC)))
    import chip_smoke as cs
    res = dryrun.lower_cell(arch, "train_4k", smoke=True, mesh_shape=(2, 2),
                            group_size=16, verbose=False)
    want = cs.predicted_collectives(tc.get_smoke_config(arch), False)
    assert res["collectives"]["calls"] == want


def test_multi_pod_cell_matches_jax_argument_bytes():
    """A cell on the 2 x 16 x 16 mesh (512 fake ranks): the batch split
    over ("pod", "data") in that order, a rank's argument bytes JAX's."""
    res = dryrun.lower_cell("qwen3-1.7b", "decode_32k", multi_pod=True,
                            depth=1, verbose=False)
    assert res["mesh"] == "2x16x16" and res["n_chips"] == 512
    assert res["kv_shard"]["local"] == [1, 4, 2048, 8, 128]
    assert res["memory"]["argument_bytes"] == jax_argument_bytes(
        "qwen3-1.7b", "decode_32k", MULTI)


def test_cli_writes_the_record(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch A --cell C --depth 1
    --out DIR`` writes the cell's JSON (and with ``--trace-out`` the span
    ``dryrun.lower``); ``--multi-pod`` runs a cell on 512 ranks."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    trace = tmp_path / "trace.json"
    for extra in (["--trace-out", str(trace)], ["--multi-pod"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-1.7b", "--cell", "decode_32k", "--depth", "1", "--out",
             str(tmp_path), "--metrics-out", str(tmp_path / "m.json"),
             *extra], env=env, capture_output=True, text=True, timeout=300,
            cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr[-3000:]
    single = json.loads((tmp_path / "qwen3-1.7b.decode_32k.single.d1.json")
                        .read_text())
    multi = json.loads((tmp_path / "qwen3-1.7b.decode_32k.multi.d1.json")
                       .read_text())
    assert single["memory"]["argument_bytes"] == jax_argument_bytes(
        "qwen3-1.7b", "decode_32k", SINGLE)
    assert multi["mesh"] == "2x16x16"
    assert single["kv_shard"]["sequence_sharded"]
    events = json.loads(trace.read_text())
    events = events.get("traceEvents", events)
    assert any(e.get("name") == "dryrun.lower" for e in events)


_XLA = """
    import json
    from repro.launch.dryrun import lower_cell
    out = {}
    for cell in ("train_4k", "decode_32k"):
        r = lower_cell("qwen3-1.7b", cell, depth=1, verbose=False)
        out[cell] = r["memory"]["argument_bytes"]
    print("XLA_ARGS " + json.dumps(out))
"""


@pytest.mark.multidevice
def test_argument_bytes_equal_xlas():
    """XLA's ``memory_analysis().argument_size_in_bytes`` of the JAX dry
    run compiled on fake devices (qwen3-1.7b, depth 1, train_4k and
    decode_32k) equals the port's per-rank argument bytes."""
    proc = run_with_devices(_XLA, n_devices=256, timeout=900)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("XLA_ARGS ")][-1]
    xla = json.loads(line[len("XLA_ARGS "):])
    for cell, want in xla.items():
        got = dryrun.lower_cell("qwen3-1.7b", cell, depth=1, verbose=False)
        assert got["memory"]["argument_bytes"] == want, cell
