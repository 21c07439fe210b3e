"""The multi-tenant serving engine of the port (``repro_torch.serve``)
against the JAX package's (``repro.serve``), on the CPU.

The model is ``tests/test_serving.py::_quantize``'s: dense, 2 layers,
d_model 32, vocab 64, f32, CLoQ 4-bit, group 16, rank 4, quantized once
by JAX and carried into the port with ``convert.params_from_jax``.

Tolerances: the allocator, the scheduler and ``synthesize_adapters`` are
held equal exactly (same seeded operations, same answers; same float32
bits); the page-pool ops exactly (they only move values); one decode
step's logits within 1e-4 (atol and rtol), the f32 decode tolerance of
``tests/test_torch_serve.py``; greedy tokens exactly.  The JAX and torch
CPU matmuls sum in different orders (about 1e-6 apart on these logits),
which no greedy token of these workloads is close enough to a tie to
feel.  Within the port, batched and sequential replays run the same torch
ops on the same rows, and their tokens are held equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import decode_step as jax_decode_step
from repro.obs import names as jax_names
from repro.serve import AdapterRegistry as JaxRegistry
from repro.serve import ServeEngine as JaxEngine
from repro.serve import adapters_from_tree as jax_adapters
from repro.serve import kv_cache as jkv
from repro.serve import run_workload as jax_run_workload
from repro.serve.engine import _strip_adapters as jax_strip
from repro.serve.registry import synthesize_adapters as jax_synth
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.checkpoint import save_tree
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import CapturedStep
from repro_torch.models import modules as tmod
from repro_torch.models.transformer import ModelConfig
from repro_torch.models.transformer import decode_step as t_decode_step
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import names as t_names
from repro_torch.serve import (AdapterError, AdapterRegistry, ServeEngine,
                               adapters_from_tree, run_workload)
from repro_torch.serve import engine as tengine
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve.registry import synthesize_adapters
from repro_torch.serve.scheduler import Scheduler
from repro_torch.utils import tree_paths
from tests.test_serving import _quantize
from tests.torch_parity import jax_to_numpy, port_params

QSPEC = dict(bits=4, group_size=16, rank=4)


def _port_cfg(d_model=32):
    return ModelConfig(name="serve-test", family="dense", n_layers=2,
                       d_model=d_model, vocab=64, n_heads=4, n_kv_heads=2,
                       d_ff=2 * d_model, dtype=torch.float32,
                       quant=tmod.QSpec(**QSPEC))


@pytest.fixture(scope="module")
def model():
    qj, cfg_j = _quantize()
    cfg_t = _port_cfg()
    return qj, cfg_j, port_params(qj, cfg_t), cfg_t


def _tenants(ranks, per_rank=2):
    return [(f"t{i}", ranks[i % len(ranks)], 100 + i)
            for i in range(per_rank * len(ranks))]


def _registries(qj, qt, ranks=(4, 8), per_rank=2, capacity=4):
    """The same tenants in a JAX and a port registry (tests/test_serving.py
    ``_registry``: round-robin over the rank buckets, seeds 100 + i)."""
    rj = JaxRegistry.from_model(qj, capacity=capacity)
    rt = AdapterRegistry.from_model(qt, capacity=capacity)
    bj, bt = jax_adapters(qj), adapters_from_tree(qt)
    names = []
    for name, rank, seed in _tenants(ranks, per_rank):
        rj.register(name, jax_synth(bj, rank, seed=seed))
        rt.register(name, synthesize_adapters(bt, rank, seed=seed))
        names.append(name)
    return rj, rt, names


def _engines(qj, cfg_j, qt, cfg_t, rj, rt, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 24)
    kw.setdefault("bucket_capacity", 4)
    return JaxEngine(qj, cfg_j, rj, **kw), ServeEngine(qt, cfg_t, rt, **kw)


def test_metric_names_are_the_references():
    assert t_names.registry_dict() == jax_names.registry_dict()


# -- allocator and scheduler ------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_matches_reference(seed):
    rng = np.random.default_rng(seed)
    aj, at = jkv.PageAllocator(13), tkv.PageAllocator(13)
    owners = []
    for i in range(300):
        if owners and rng.random() < 0.4:
            o = owners.pop(int(rng.integers(len(owners))))
            assert _outcome(lambda: aj.free(o)) == _outcome(lambda: at.free(o))
        else:
            n = int(rng.integers(1, 6))
            got = _outcome(lambda: at.alloc(i, n))
            assert _outcome(lambda: aj.alloc(i, n)) == got
            if got[0] == "ok":
                owners.append(i)
        assert aj.n_free == at.n_free and aj.can_alloc(3) == at.can_alloc(3)
        at.check()
    for o in owners:
        assert aj.owned(o) == at.owned(o)
    assert tkv.pages_needed(17, 8) == jkv.pages_needed(17, 8) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_reference(seed):
    """Seeded submits, ticks and retires over two buckets and a tight page
    pool: every admission, page assignment and retirement is the
    reference's, and so is the trace."""
    rng = np.random.default_rng(seed)
    sj = JaxScheduler({4: 2}, jkv.PageAllocator(9))
    st = Scheduler({4: 2}, tkv.PageAllocator(9))
    for s in (sj, st):
        s.ensure_bucket(8, 3)
    rid = 0
    for _ in range(200):
        op = rng.random()
        if op < 0.35:
            bucket, n = (4, 8)[int(rng.integers(2))], int(rng.integers(1, 5))
            assert _outcome(lambda: sj.submit(rid, bucket, n)) == \
                _outcome(lambda: st.submit(rid, bucket, n))
            rid += 1
        elif op < 0.7:
            active = st.tick()
            assert sj.tick() == active
            for ent in active.values():
                for _slot, r in ent:
                    assert sj.pages_of(r) == st.pages_of(r)
                    assert sj.slot_of(r) == st.slot_of(r)
        else:
            live = sorted(st._where)
            if live:
                r = live[int(rng.integers(len(live)))]
                sj.retire(r)
                st.retire(r)
        assert sj.outstanding() == st.outstanding()
        st.allocator.check()
    assert sj.trace == st.trace and sj.retired == st.retired
    assert sj.allocator.n_free == st.allocator.n_free


# -- adapters and the registry ----------------------------------------------


@pytest.mark.parametrize("rank", [4, 8])
def test_synthesize_adapters_bit_equal(model, rank):
    qj, _, qt, _ = model
    want = jax_synth(jax_adapters(qj), rank, seed=7)
    got = synthesize_adapters(adapters_from_tree(qt), rank, seed=7)
    assert sorted(got) == sorted(want)
    for site in want:
        for leaf in ("lora_a", "lora_b"):
            assert got[site][leaf].dtype == np.float32
            np.testing.assert_array_equal(got[site][leaf],
                                          want[site][leaf])


def test_registry_stacks_match_reference(model):
    qj, _, qt, _ = model
    rj, rt, _ = _registries(qj, qt)
    assert rt.ranks() == rj.ranks() and rt.tenants() == rj.tenants()
    assert rt.sites() == rj.sites()
    for rank in rj.ranks():
        for site in rj.sites():
            for leaf in ("lora_a", "lora_b"):
                np.testing.assert_array_equal(
                    rt.stacks(rank)[site][leaf].numpy(),
                    np.asarray(rj.stacks(rank)[site][leaf]))


def test_registry_writes_slots_in_place(model):
    """register/swap/evict write the bucket's stacks in place, so a decode
    step captured over them sees a hot swap without a new capture."""
    _, _, qt, _ = model
    reg = AdapterRegistry.from_model(qt, capacity=2)
    base = adapters_from_tree(qt)
    reg.register("A", synthesize_adapters(base, 4, seed=1))
    st = reg.stacks(4)
    ptrs = {s: st[s]["lora_a"].data_ptr() for s in reg.sites()}
    new = synthesize_adapters(base, 4, seed=2)
    reg.swap("A", new)
    reg.register("B", synthesize_adapters(base, 4, seed=3))
    reg.evict("B")
    for site in reg.sites():
        assert reg.stacks(4)[site]["lora_a"].data_ptr() == ptrs[site]
        np.testing.assert_array_equal(
            reg.stacks(4)[site]["lora_a"][:, 0].numpy(),
            new[site]["lora_a"])
        assert not reg.stacks(4)[site]["lora_b"][:, 1].any()


def test_evicted_and_unknown_tenants_raise(model):
    _, _, qt, cfg_t = model
    reg = AdapterRegistry.from_model(qt, capacity=1)
    base = adapters_from_tree(qt)
    reg.register("A", synthesize_adapters(base, 4, seed=1))
    with pytest.raises(AdapterError, match="full"):
        reg.register("B", synthesize_adapters(base, 4, seed=2))
    with pytest.raises(AdapterError, match="already registered"):
        reg.register("A", synthesize_adapters(base, 4, seed=2))
    eng = ServeEngine(qt, cfg_t, reg, page_size=4, max_len=24)
    reg.evict("A")
    with pytest.raises(AdapterError, match="not registered"):
        eng.submit([1], "A", max_new=2)


# -- page-pool ops ------------------------------------------------------------


def test_pool_ops_match_reference():
    rng = np.random.default_rng(0)
    L, n_pages, P, H, d, B, maxp = 2, 9, 4, 2, 8, 3, 2
    pool = rng.normal(size=(L, n_pages, P, H, d)).astype(np.float32)
    pt = np.array([[3, 5], [1, 2], [0, 0]], np.int32)
    lens = np.array([6, 1, 0], np.int32)
    new = rng.normal(size=(L, B, H, d)).astype(np.float32)
    gj = np.asarray(jkv.gather_pages(jnp.asarray(pool), jnp.asarray(pt)))
    gt = tkv.gather_pages(torch.from_numpy(pool), torch.from_numpy(pt))
    np.testing.assert_array_equal(gt.numpy(), gj)
    ej = np.asarray(jkv.extract_token(jnp.asarray(gj), jnp.asarray(lens)))
    et = tkv.extract_token(gt, torch.from_numpy(lens))
    np.testing.assert_array_equal(et.numpy(), ej)
    sj = np.asarray(jkv.scatter_token(jnp.asarray(pool), jnp.asarray(new),
                                      jnp.asarray(pt), jnp.asarray(lens)))
    tp = torch.from_numpy(pool.copy())
    st = tkv.scatter_token(tp, torch.from_numpy(new), torch.from_numpy(pt),
                           torch.from_numpy(lens))
    assert st is tp                      # written in place
    np.testing.assert_array_equal(st[:, 1:].numpy(), sj[:, 1:])
    kj, kt = jkv.init_pools(L, n_pages, P, H, d, jnp.float32), \
        tkv.init_pools(L, n_pages, P, H, d, torch.float32, device="cpu")
    assert kt[0].shape == kj[0].shape and not kt[0].any()


# -- the engine ---------------------------------------------------------------


def test_decode_step_logits_match_jax_on_a_gathered_cache(model):
    """One serving step's pieces (adapters spliced by slot, pages gathered,
    decode with a vector idx) give the JAX decode_step's logits and new
    K/V rows within 1e-4 on the same random pool."""
    qj, cfg_j, qt, cfg_t = model
    rj, rt, _ = _registries(qj, qt)
    rng = np.random.default_rng(3)
    L, P, maxp, hd = cfg_t.n_layers, 4, 3, 8
    pool = rng.normal(size=(2, L, 10, P, 2, hd)).astype(np.float32)
    pt = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [7, 8, 9]], np.int32)
    lens = np.array([9, 5, 0, 11], np.int32)
    ad = np.array([0, 1, 1, 0], np.int32)
    toks = np.array([[3], [17], [40], [63]], np.int32)
    for rank in (4, 8):
        pj = dict(jax_strip(qj, rj.sites()))
        pj["blocks"] = jax.tree.map(lambda x: x, pj["blocks"])
        for site in rj.sites():
            keys = site.split(".")
            node = pj["blocks"]
            for k in keys[:-1]:
                node = node[k]
            leaf = dict(node[keys[-1]])
            st = rj.stacks(rank)[site]
            leaf["lora_a"] = jnp.take(st["lora_a"], jnp.asarray(ad), axis=1)
            leaf["lora_b"] = jnp.take(st["lora_b"], jnp.asarray(ad), axis=1)
            node[keys[-1]] = leaf
        cache_j = {"k": jkv.gather_pages(jnp.asarray(pool[0]),
                                         jnp.asarray(pt)),
                   "v": jkv.gather_pages(jnp.asarray(pool[1]),
                                         jnp.asarray(pt)),
                   "idx": jnp.asarray(lens)}
        lj, new_j = jax_decode_step(pj, cfg_j, cache_j, jnp.asarray(toks))
        pt_t = tengine.splice_adapters(
            tengine._strip_adapters(qt, rt.sites()), rt.stacks(rank),
            torch.from_numpy(ad), rt.sites())
        cache_t = {"k": tkv.gather_pages(torch.from_numpy(pool[0]),
                                         torch.from_numpy(pt)),
                   "v": tkv.gather_pages(torch.from_numpy(pool[1]),
                                         torch.from_numpy(pt)),
                   "idx": torch.from_numpy(lens)}
        with torch.no_grad():
            lt, new_t = t_decode_step(pt_t, cfg_t, cache_t,
                                      torch.from_numpy(toks))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                tkv.extract_token(new_t[kv], torch.from_numpy(lens)).numpy(),
                np.asarray(jkv.extract_token(new_j[kv], jnp.asarray(lens))),
                atol=1e-4, rtol=1e-4)


MIXED = [(f"t{i % 4}", [1 + i, 2 + i, 3], 4 + i % 3) for i in range(8)]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_tokens_match_jax_engine(model, use_kernel):
    """Mixed ranks (4 and 8), 4 tenants, staggered prompts and lengths:
    the port's engine gives the JAX ServeEngine's greedy tokens, with the
    kernels off and with them on (the port's plain versions; Pallas in
    interpret mode for JAX), and its serve.* counters count the run."""
    qj, cfg_j, qt, cfg_t = model
    rj, rt, _ = _registries(qj, qt)
    ej, et = _engines(qj, cfg_j, qt, cfg_t, rj, rt, use_kernel=use_kernel)
    before = t_metrics.snapshot()["counters"]
    got = run_workload(et, MIXED)
    after = t_metrics.snapshot()["counters"]
    assert got == jax_run_workload(ej, MIXED)
    assert all(len(got[i]) == MIXED[i][2] for i in range(len(MIXED)))
    assert et.decodes.keys() == {4, 8} and not et.graph
    done = after[t_names.SERVE_FINISHED] - before.get(
        t_names.SERVE_FINISHED, 0)
    toks = after[t_names.SERVE_TOKENS] - before.get(t_names.SERVE_TOKENS, 0)
    assert done == len(MIXED) and toks == sum(m for _, _, m in MIXED)
    et.scheduler.allocator.check()


def test_batched_equals_sequential(model):
    qj, _, qt, cfg_t = model
    _, rt, _ = _registries(qj, qt)
    eng = lambda: ServeEngine(qt, cfg_t, rt, page_size=4, max_len=24)  # noqa
    assert run_workload(eng(), MIXED) == \
        run_workload(eng(), MIXED, sequential=True)


def test_batched_equals_sequential_across_hot_swap(model):
    """tests/test_serving.py::test_parity_across_hot_swap on the port: the
    request in flight across a swap keeps its own weights, the swapped
    tenant's next request uses the new ones, each equal to a replay."""
    _, _, qt, cfg_t = model
    base = adapters_from_tree(qt)
    old_a = synthesize_adapters(base, 4, seed=1)
    new_a = synthesize_adapters(base, 4, seed=2)
    b_ad = synthesize_adapters(base, 4, seed=3)

    def engine(reg):
        return ServeEngine(qt, cfg_t, reg, page_size=4, max_len=24)

    reg = AdapterRegistry.from_model(qt, capacity=4)
    reg.register("A", old_a)
    reg.register("B", b_ad)
    eng = engine(reg)
    rid_b = eng.submit([5, 6], "B", max_new=14)
    rid_a1 = eng.submit([7], "A", max_new=3)
    done = set()
    for _ in range(40):
        done.update(eng.step())
        if rid_a1 in done:
            break
    assert rid_a1 in done and rid_b not in done
    reg.swap("A", new_a)
    rid_a2 = eng.submit([8], "A", max_new=3)
    eng.run()

    reg_old = AdapterRegistry.from_model(qt, capacity=4)
    reg_old.register("A", old_a)
    reg_old.register("B", b_ad)
    ref_a1 = run_workload(engine(reg_old), [("A", [7], 3)])[0]
    ref_b = run_workload(engine(reg_old), [("B", [5, 6], 14)])[0]
    reg_old.swap("A", new_a)
    ref_a2 = run_workload(engine(reg_old), [("A", [8], 3)])[0]
    assert eng.result(rid_a1) == ref_a1
    assert eng.result(rid_b) == ref_b
    assert eng.result(rid_a2) == ref_a2


def test_page_reuse_and_base_untouched(model):
    """More requests than the pool holds at once: pages recycle, every
    request completes, the allocator ends clean, and neither the engine's
    base nor the caller's tree changes."""
    _, _, qt, cfg_t = model
    base = adapters_from_tree(qt)
    reg = AdapterRegistry.from_model(qt, capacity=2)
    for i in range(2):
        reg.register(f"t{i}", synthesize_adapters(base, 4, seed=i))
    before = {p: t.clone() for p, t in tree_paths(qt).items()}
    eng = ServeEngine(qt, cfg_t, reg, page_size=4, max_len=24,
                      bucket_capacity=2, n_pages=7)
    reqs = [(f"t{i % 2}", [1 + i], 8) for i in range(6)]
    out = run_workload(eng, reqs)
    assert all(len(out[i]) == 8 for i in range(6))
    alloc = eng.scheduler.allocator
    alloc.check()
    assert alloc.n_free == alloc.n_usable
    for p, t in tree_paths(qt).items():
        assert torch.equal(t, before[p]), p
    seq = ServeEngine(qt, cfg_t, reg, page_size=4, max_len=24,
                      bucket_capacity=2, n_pages=7)
    assert run_workload(seq, reqs, sequential=True) == out


def test_engine_refuses_what_it_cannot_do(model, tmp_path, monkeypatch):
    """A graph off CUDA and unstacked params raise; ``compile_cache`` is
    accepted and kept (the kernel libraries' directory)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "_cache", None)
    _, _, qt, cfg_t = model
    reg = AdapterRegistry.from_model(qt, capacity=2)
    eng = ServeEngine(qt, cfg_t, reg, compile_cache=str(tmp_path / "x"))
    assert eng.compile_cache is build.active_cache()
    assert eng.compile_cache.directory == tmp_path / "x"
    assert ServeEngine(qt, cfg_t, reg).compile_cache is None
    with pytest.raises(ValueError, match="CUDA"):
        ServeEngine(qt, cfg_t, reg, graph=True)
    with pytest.raises(ValueError, match="scan"):
        ServeEngine(qt, dataclasses.replace(cfg_t, scan_layers=False), reg)


# -- checkpoints as tenants ---------------------------------------------------


def test_foreign_checkpoint_one_adapter_error(model, tmp_path):
    """tests/test_serving.py::test_foreign_manifest_one_legible_error on
    the port, with the foreign model written by the JAX package."""
    from repro.checkpoint.manager import save_tree as jax_save
    _, _, qt, _ = model
    reg = AdapterRegistry.from_model(qt, capacity=2)
    foreign, _ = _quantize(d_model=48, rank=4, seed=7)
    jax_save(foreign, str(tmp_path / "foreign"), 0)
    with pytest.raises(AdapterError, match="foreign or stale"):
        reg.load("bad", str(tmp_path / "foreign"))
    save_tree({"embed": {"w": torch.zeros(4, 4)}},
              str(tmp_path / "noadapter"), 0)
    with pytest.raises(AdapterError, match="no stacked LoRA adapter"):
        reg.load("bad", str(tmp_path / "noadapter"))
    with pytest.raises(AdapterError, match="no complete checkpoint"):
        reg.load("bad", str(tmp_path / "empty"))
    assert reg.tenants() == {}


def test_jax_checkpoint_loads_as_a_port_tenant(model, tmp_path):
    """A quantized model saved by the JAX package serves in the port as a
    tenant whose adapters are the base's own, with the JAX engine's
    tokens."""
    from repro.checkpoint.manager import save_tree as jax_save
    qj, cfg_j, qt, cfg_t = model
    jax_save(qj, str(tmp_path), 0)
    rj = JaxRegistry.from_model(qj, capacity=2)
    rt = AdapterRegistry.from_model(qt, capacity=2)
    rj.load("tenant", str(tmp_path))
    assert rt.load("tenant", str(tmp_path)) == 0
    ej, et = _engines(qj, cfg_j, qt, cfg_t, rj, rt, bucket_capacity=2)
    reqs = [("tenant", [3, 4], 4), ("tenant", [9], 5)]
    assert run_workload(et, reqs) == jax_run_workload(ej, reqs)


def test_train_cli_adapter_serves_as_a_tenant(tmp_path, capsys):
    """The paper's workflow on the CPU: the port's train CLI fine-tunes and
    saves (``--ckpt-dir``), and the serve CLI loads that checkpoint as a
    tenant (``--adapter``) beside synthetic ones of two ranks, takes the
    engine route and prints its summary."""
    ck = str(tmp_path / "ckpt")
    assert ttrain.main(["--arch", "qwen3-1.7b", "--smoke", "--device",
                        "cpu", "--steps", "2", "--batch", "2", "--seq-len",
                        "16", "--calib-batches", "1", "--rank", "8",
                        "--ckpt-dir", ck]) == 0
    args = tserve.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--requests",
         "6", "--max-new", "4", "--tenants", "2", "--ranks", "8,4",
         "--adapter", f"tuned={ck}"])
    res = tserve.run(args)
    s = res["serve"]
    assert res["route"] == "engine" and res["tenants"][-1] == "tuned"
    assert s["requests_done"] == 6 and s["tokens"] == 24
    assert s["rank_buckets"] == [4, 8] and set(s["decodes"]) == {4, 8}
    served = [o for t, o in zip(s["tenant_of"], s["outputs"])
              if t == "tuned"]
    assert len(served) == 2 and all(len(o) == 4 for o in served)
    trained = res["registry"].stacks(8)["attn.q"]["lora_a"][:, 1]
    synth = res["registry"].stacks(8)["attn.q"]["lora_a"][:, 0]
    assert trained.abs().sum() > 0 and not torch.equal(trained, synth)
    capsys.readouterr()
    assert tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device",
                        "cpu", "--requests", "4", "--max-new", "4",
                        "--tenants", "3", "--adapter", f"tuned={ck}"]) == 0
    out = capsys.readouterr().out
    assert "[serve] requests=4/4 " in out and "tokens=16 " in out
    assert "tenants=4 rank_buckets=8 p50_ms=" in out


# -- the captured step's bookkeeping (the capture itself needs the card) ----


def test_captured_launches_are_counted_per_replay():
    ops.reset_launch_counts()
    ops.add_replayed({"gram": 2})
    with ops.captured_launches() as got:
        ops._gram.launches += 3              # what a wrapper does in capture
        ops._flash.launches += 1
    assert got == {"dequant_matmul": 0, "dequant_matmul_lora": 0,
                   "flash_attention": 1, "gram": 3}
    assert ops.launch_counts()["gram"] == 2   # the capture ran nothing
    ops.add_replayed(got)
    ops.add_replayed(got)
    assert ops.launch_counts() == {"dequant_matmul": 0,
                                   "dequant_matmul_lora": 0,
                                   "flash_attention": 2, "gram": 8}
    ops.reset_launch_counts()


def test_captured_step_takes_cuda_tensors_only():
    step = CapturedStep(lambda x: x + 1)
    with pytest.raises(ValueError, match="CUDA"):
        step(torch.zeros(3))
    assert step.graph is None and step.calls == 0


class _FakeCapture:
    """``torch.cuda.graph`` as the card's torch runs it: enter the capture
    stream, then begin; on exit end the capture (``capture_end``) and only
    then leave the stream.  ``end_raises``: ``capture_end`` raises, as it
    does on an invalidated capture, and the stream is never left."""

    def __init__(self, current: list, end_raises: bool):
        self.current, self.end_raises = current, end_raises
        outer = self

        class _Ctx:
            def __exit__(self, *exc):
                outer.current[0] = "caller"
                outer.current.append("left")

        self.stream_ctx = _Ctx()

    def __enter__(self):
        self.current[0] = "capture"

    def __exit__(self, *exc):
        if self.end_raises:
            raise RuntimeError("CUDA error: operation failed due to a "
                               "previous error during capture")
        self.stream_ctx.__exit__(*exc)


@pytest.mark.parametrize("case", ["end_raises", "body_raises", "no_api"])
def test_failed_capture_hands_back_pool_and_stream(monkeypatch, case):
    """A capture whose end raises (torch's ``capture_end`` raises before it
    ends the allocator's pool, and ``torch.cuda.graph`` never leaves its
    stream): ``CapturedStep`` ends and releases the graph's pool, leaves
    the stream context, takes back the launches recorded and re-raises;
    the pool is the handle it named for the capture (a failed capture's
    ``CUDAGraph.pool`` raises).
    A body that raises while the capture stays valid (``capture_end``
    succeeds and the graph keeps its pool) touches neither; a torch
    without the private calls raises, naming the call, and still leaves
    the stream."""
    current, pool_calls = ["caller"], []
    side = type("Stream", (), {"device": torch.device("cuda", 3)})()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 5))
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool, stream: (
        _FakeCapture(current, end_raises=case != "body_raises")))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: (
        side if current[0] == "capture" else "caller"))
    for name in ("_cuda_endAllocateToPool", "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name, lambda dev, pool, name=name:
                            pool_calls.append((name, dev, pool)),
                            raising=False)
    if case == "no_api":
        monkeypatch.delattr(torch._C, "_cuda_releasePool")

    def body(x):
        ops._flash.launches += 1          # a launch recorded into the graph
        raise ValueError("the body")

    step = CapturedStep(body)
    step._stream = side
    ops.reset_launch_counts()
    want = {"end_raises": "previous error during capture",
            "body_raises": "the body",
            "no_api": "no torch._C._cuda_releasePool"}[case]
    with pytest.raises((RuntimeError, ValueError), match=want):
        step._capture((torch.zeros(3),))
    assert current == ["caller", "left"]
    assert step.graph is None and step.outputs is None
    assert ops.launch_counts()["flash_attention"] == 0
    assert pool_calls == {
        "end_raises": [("_cuda_endAllocateToPool", 3, (0, 5)),
                       ("_cuda_releasePool", 3, (0, 5))],
        "body_raises": [], "no_api": []}[case]


def test_fixed_slots_graph_needs_cuda(model):
    _, _, qt, cfg_t = model
    with pytest.raises(ValueError, match="CUDA"):
        tserve.serve_fixed_slots(qt, cfg_t, batch=2, cache_len=8,
                                 requests=2, max_new=2, seed=0,
                                 device="cpu", graph=True)


def test_jax_tree_round_trip_keeps_adapter_sites(model):
    qj, _, qt, _ = model
    assert sorted(adapters_from_tree(qt)) == sorted(jax_adapters(qj))
    assert sorted(tengine._strip_adapters(qt, ["attn.q"])["blocks"]["attn"]
                  ["q"]) == sorted(k for k in jax_to_numpy(qj)["blocks"]
                                   ["attn"]["q"]
                                   if k not in ("lora_a", "lora_b"))
