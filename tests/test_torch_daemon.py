"""The port's device layer, zoo and daemon against the reference, on the CPU.

Inputs are made by numpy from seeds and handed to both packages; module
weights cross from the reference's init through `convert`.  Tolerances:
mandelbrot escape counts exactly equal (the port writes the update as XLA's
CPU backend contracts it); sobel 1e-5 (shifted adds against XLA's
convolution); matmul 2e-5 (fp32); the reduced lm-forward 2e-2 (its compute
is bf16).  The port's slots here are on the CPU, where the kernel wrappers
run their plain versions.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest

from torch_cpu import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs, core as ref_core  # noqa: E402
from repro.core import bus as ref_bus, zoo as ref_zoo  # noqa: E402
from repro.core import module as ref_module  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import AdmissionRejected, Daemon, PolicyConfig, \
    Registry, Shell, default_registry, uniform_shell  # noqa: E402
from repro_torch.core import bus, zoo  # noqa: E402
from repro_torch.core.module import AccelModule, TensorSpec, \
    run_placement  # noqa: E402
from repro_torch.core.shell import Slot, SlotSpec  # noqa: E402
from repro_torch.launch.serve import DaemonServeRun, serve_daemon  # noqa: E402
from repro_torch.models import convert  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread while this file runs: the daemon runs chunks in
    up to 8 worker threads, and a team of intra-op threads for each of
    them oversubscribes the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_shell(name="host1_s1", n=1) -> Shell:
    return Shell(uniform_shell(name, (1, n), n), [CPU] * n)


def _ref_mesh():
    spec = ref_core.uniform_shell("ref1_s1", (1, 1), 1)
    return ref_core.Shell(spec).slots[0].mesh


def _mandel_inputs(seed=0):
    """tests/test_core_daemon.py's tiles."""
    rng = np.random.default_rng(seed)
    re = rng.uniform(-2, 1, (256, 256)).astype(np.float32)
    im = rng.uniform(-1.5, 1.5, (256, 256)).astype(np.float32)
    return re, im


def _place(builder, **kw):
    slot = _cpu_shell().slots[0]
    return AccelModule("m", lambda s, f: builder(s, f, **kw), [1]).place(
        slot, 1)


# -- the zoo against the reference -----------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 3, 9])
def test_mandelbrot_counts_equal_reference(seed):
    re, im = _mandel_inputs(seed)
    want = jax.jit(ref_zoo.build_mandelbrot(_ref_mesh(), 1).fn)(None, re, im)
    got = run_placement(_place(zoo.build_mandelbrot), re, im)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sobel_matches_reference():
    img = np.random.default_rng(2).random((1024, 1024)).astype(np.float32)
    want = jax.jit(ref_zoo.build_sobel(_ref_mesh(), 1).fn)(None, img)
    got = run_placement(_place(zoo.build_sobel), img)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_matmul_matches_reference_with_its_weights():
    prog = ref_zoo.build_matmul(_ref_mesh(), 1)
    w = jax.tree.map(np.asarray, prog.init_weights(jax.random.PRNGKey(0)))
    x = np.random.default_rng(4).standard_normal((512, 512)).astype(
        np.float32)
    want = jax.jit(prog.fn)(w, x)
    port = zoo.build_matmul(None, 1)
    got = port.fn(convert.tree_from_numpy(w, CPU), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_lm_forward_reduced_matches_reference():
    ref = ref_zoo.build_lm_forward(_ref_mesh(), 1)
    params = jax.tree.map(np.asarray, ref.init_weights(jax.random.PRNGKey(3)))
    tokens = np.random.default_rng(5).integers(0, 256, (8, 64),
                                               dtype=np.int32)
    want = jax.jit(ref.fn)(jax.tree.map(jnp.asarray, params), tokens)
    port = zoo.build_lm_forward(None, 1)
    cfg = dataclasses.replace(configs.get("llama3.2-3b", reduced=True),
                              attn_impl="pallas")
    with torch.inference_mode():
        got = port.fn(convert.params_from_numpy(params, cfg, CPU),
                      torch.from_numpy(tokens))
    assert got.shape == (8, cfg.padded_vocab) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("name", ["mandelbrot", "sobel", "matmul",
                                  "lm-forward"])
def test_signature_reads_as_the_reference(name):
    """A registry JSON names shapes and dtypes alike in both packages."""
    builder = name.replace("-", "_")
    want = getattr(ref_zoo, f"build_{builder}")(_ref_mesh(), 1).signature()
    got = getattr(zoo, f"build_{builder}")(None, 1).signature()
    assert got == want


def test_full_width_lm_forward_signature():
    """`reduced=False` is the full llama3.2-3b: 3.21e9 fp32 params."""
    sig = zoo.build_lm_forward(None, 1, reduced=False).signature()
    n = sum(int(np.prod(leaf["shape"])) for leaf in
            _leaves(sig["weights"]))
    assert n == ref_api.param_count(ref_configs.get("llama3.2-3b"))
    assert sig["inputs"] == [{"shape": [8, 64], "dtype": "int32"}]


def _leaves(tree):
    if isinstance(tree, dict) and "shape" not in tree:
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- the bus adaptors against the reference --------------------------------

ADAPTOR_CASES = [(r, c, d) for r, c in ((1, 1), (1, 64), (64, 1), (17, 33),
                                        (63, 64), (64, 64))
                 for d in ("float32", "float64", "int32")]


@pytest.mark.parametrize("rows,cols,dtype", ADAPTOR_CASES)
def test_adaptor_report_and_values_equal_reference(rows, cols, dtype):
    src = np.arange(rows * cols, dtype=dtype).reshape(rows, cols)
    (want,), want_rep = ref_bus.adapt_inputs(
        (src,), (jax.ShapeDtypeStruct((64, 64), jnp.float32),))
    (got,), rep = bus.adapt_inputs(
        (src,), (TensorSpec((64, 64), torch.float32),))
    assert dataclasses.asdict(rep) == dataclasses.asdict(want_rep)
    assert got.dtype == torch.float32 and tuple(got.shape) == (64, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spec_pair(shape, dtype):
    return (jax.ShapeDtypeStruct(shape, getattr(jnp, dtype)),
            TensorSpec(shape, getattr(torch, dtype)))


STRUCTURED_CASES = {
    # one chunk argument (float32 [4,8], int64 [2,8]) against the
    # interface (float32 [4,8], int32 [4,8]): a cast and a pad
    "tuple": ((np.arange(32, dtype=np.float32).reshape(4, 8),
               np.arange(16, dtype=np.int64).reshape(2, 8)),
              (((4, 8), "float32"), ((4, 8), "int32"))),
    # nested dicts and lists, keys given out of sorted order
    "nested_dict": ({"z": np.ones((3, 5), np.float64),
                     "a": [np.arange(6, dtype=np.int32).reshape(2, 3),
                           {"m": np.full((8,), 2.0, np.float32)}]},
                    {"a": [((4, 3), "int32"), {"m": ((8,), "float32")}],
                     "z": ((3, 8), "float32")}),
}


def _specs(tree, which):
    """The interface from (shape, dtype name) leaves: jax's specs
    (which=0) or the port's (which=1)."""
    if isinstance(tree, dict):
        return {k: _specs(v, which) for k, v in tree.items()}
    if isinstance(tree[-1], str):
        return _spec_pair(*tree)[which]
    return type(tree)(_specs(v, which) for v in tree)


@pytest.mark.parametrize("case", sorted(STRUCTURED_CASES))
def test_adaptor_structured_chunk_arg_equals_reference(case):
    """A chunk argument that is a tuple or a nested dict is adapted leaf
    by leaf, as the reference's pytree flatten pairs the leaves."""
    given, want = STRUCTURED_CASES[case]
    (ref_out,), ref_rep = ref_bus.adapt_inputs((given,), (_specs(want, 0),))
    (out,), rep = bus.adapt_inputs((given,), (_specs(want, 1),))
    assert dataclasses.asdict(rep) == dataclasses.asdict(ref_rep)
    assert not rep.identity and rep.casts >= 1 and rep.pads >= 1
    ref_leaves, ref_tree = jax.tree.flatten(ref_out)
    leaves, tree = jax.tree.flatten(out)
    assert tree == ref_tree          # the same structure, rebuilt
    for got, ref in zip(leaves, ref_leaves):
        assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_adaptor_takes_tensors_and_rejects_oversize():
    (out,), rep = bus.adapt_inputs((torch.ones(8, 8),),
                                   (TensorSpec((8, 8), torch.float32),))
    assert rep.identity and rep.bytes_moved == 0 and out.shape == (8, 8)
    with pytest.raises(AssertionError):
        ref_bus.adapt_inputs((np.zeros((9, 8), np.float32),),
                             (jax.ShapeDtypeStruct((8, 8), jnp.float32),))
    with pytest.raises(AssertionError):
        bus.adapt_inputs((np.zeros((9, 8), np.float32),),
                         (TensorSpec((8, 8), torch.float32),))
    assert bus.strip_outputs([torch.ones(4, 2)], 3)[0].shape == (3, 2)


# -- shells, slots and placement -------------------------------------------


def test_shell_binds_slots_to_devices():
    shell = _cpu_shell("host2_s2", 2)
    assert [s.device for s in shell.slots] == [CPU, CPU]
    assert all(s.stream is None for s in shell.slots)
    merged = shell.merged_slot([0, 1])
    assert merged.spec.shape == (1, 2) and merged.device == CPU
    assert shell.slots[0].congruence_key == ((1, 1), ("data", "model"))


def test_slot_over_two_gpus_has_a_stream_and_a_replica_per_device(
        monkeypatch):
    """A rectangle over two GPUs binds both: one stream on each (built here
    with a stand-in for `torch.cuda.Stream`: this machine may have no
    CUDA), and a module placed on a two-entry slot holds one weight
    replica on each entry (two CPU entries here)."""
    class FakeStream:
        def __init__(self, device):
            self.device = device

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    gpus = [torch.device("cuda", 0), torch.device("cuda", 1)]
    slot = Slot(SlotSpec("s0+s1", (0, 0), (1, 2)),
                np.array([gpus], dtype=object), ("data", "model"))
    assert slot.run_devices == gpus and slot.device == gpus[0]
    assert [s.device for s in slot.streams] == gpus
    assert slot.stream is slot.streams[0]
    merged = _cpu_shell("host2_s2", 2).merged_slot([0, 1])
    pl = AccelModule("matmul", zoo.build_matmul, [2]).place(merged, 2)
    assert len(pl.replicas) == 2 and pl.weights_on_slot is pl.replicas[0]
    for rep, dev in zip(pl.replicas, merged.run_devices):
        assert rep["a"].device == dev
        torch.testing.assert_close(rep["a"], pl.module.host_weights(2)["a"],
                                   rtol=0, atol=0)


def test_place_times_upload_and_warm_up_and_counts_cache_hits():
    mod = AccelModule("matmul", zoo.build_matmul, [1])
    shell = _cpu_shell("host2_s2", 2)
    first = mod.place(shell.slots[0], 1)
    second = mod.place(shell.slots[1], 1)      # a congruent slot
    assert not first.cache_hit and second.cache_hit
    assert first.compile_time_s > 0 and first.load_time_s >= 0
    assert mod._compile_count == 2 and len(mod._programs) == 1
    # host weights from a CPU generator seeded with weights_key, once
    torch.testing.assert_close(first.weights_on_slot["a"],
                               mod.host_weights(1)["a"])
    x = np.random.default_rng(0).standard_normal((512, 512)).astype(
        np.float32)
    torch.testing.assert_close(run_placement(first, x),
                               run_placement(second, x))


# -- a slot of four CPU entries: split, run on each, gather ----------------


def _zoo_case(name):
    """(builder, chunk args, reference builder, tolerance against the
    reference) of each zoo module, as the tests above take them."""
    re, im = _mandel_inputs(0)
    img = np.random.default_rng(2).random((1024, 1024)).astype(np.float32)
    x = np.random.default_rng(4).standard_normal((512, 512)).astype(
        np.float32)
    toks = np.random.default_rng(5).integers(0, 256, (8, 64), dtype=np.int32)
    return {"mandelbrot": (zoo.build_mandelbrot, (re, im), 0.0),
            "sobel": (zoo.build_sobel, (img,), 1e-5),
            "matmul": (zoo.build_matmul, (x,), 2e-5),
            "lm-forward": (zoo.build_lm_forward, (toks,), 2e-2)}[name]


def _ref_weights(name):
    """The reference module's init weights, as numpy (None without)."""
    prog = getattr(ref_zoo, f"build_{name.replace('-', '_')}")(_ref_mesh(), 1)
    if prog.init_weights is None:
        return None
    return jax.tree.map(np.asarray, prog.init_weights(jax.random.PRNGKey(0)))


def _on(slot, name, weights):
    builder, args, _ = _zoo_case(name)
    mod = AccelModule(name, builder, [slot.spec.shape[1]])
    if weights is not None:
        mod.program(slot, slot.spec.shape[1])
        mod._host_weights[slot.spec.shape[1]] = convert.tree_from_numpy(
            weights, CPU)
    return run_placement(mod.place(slot, slot.spec.shape[1]), *args)


ZOO = ["mandelbrot", "sobel", "matmul", "lm-forward"]


@pytest.fixture(scope="module")
def four_entry_runs():
    shell = _cpu_shell("host4_s4", 4)
    merged = shell.merged_slot([0, 1, 2, 3])
    one = _cpu_shell().slots[0]
    out = {}
    for name in ZOO:
        w = _ref_weights(name)
        out[name] = (_on(merged, name, w), _on(one, name, w), w)
    return out


@pytest.mark.parametrize("name", ZOO)
def test_four_entry_slot_equals_one_entry_slot_bit_for_bit(name,
                                                           four_entry_runs):
    """Each of the 4 entries runs a quarter of the rows (sobel with one
    row of halo from each neighbour); the gathered output is the one-entry
    slot's, bit for bit."""
    four, one, _ = four_entry_runs[name]
    assert four.shape == one.shape and four.dtype == one.dtype
    np.testing.assert_array_equal(four.float().numpy(), one.float().numpy())


@pytest.mark.parametrize("name", ZOO)
def test_four_entry_slot_matches_reference_run_placement(name,
                                                         four_entry_runs):
    """Against the reference's `run_placement` of the same module and
    weights, at the tolerances of the tests above."""
    four, _, w = four_entry_runs[name]
    _, args, tol = _zoo_case(name)
    mod = ref_module.AccelModule(
        name, getattr(ref_zoo, f"build_{name.replace('-', '_')}"), [1])
    slot = ref_core.Shell(ref_core.uniform_shell("r1", (1, 1), 1)).slots[0]
    mod.program(slot, 1)
    if w is not None:
        mod._host_weights[1] = jax.tree.map(jnp.asarray, w)
    want = np.asarray(ref_module.run_placement(mod.place(slot, 1), *args),
                      np.float32)
    got = four.float().numpy()
    if tol:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        np.testing.assert_array_equal(got, want)


# -- the daemon on a CPU slot (tests/test_core_daemon.py's cases) ----------


@pytest.fixture(scope="module")
def daemon():
    shell = _cpu_shell()
    reg = default_registry()
    reg.register_shell(shell.spec)
    d = Daemon(shell, reg)
    yield d
    d.shutdown()


def test_single_job_roundtrip(daemon):
    re, im = _mandel_inputs()
    h = daemon.submit("alice", "mandelbrot", [(re, im)])
    (out,) = h.future.result(timeout=120)
    want = jax.jit(ref_zoo.build_mandelbrot(_ref_mesh(), 1).fn)(None, re, im)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_multi_tenant_concurrent_jobs(daemon):
    re, im = _mandel_inputs(seed=1)
    img = np.random.default_rng(2).random((1024, 1024)).astype(np.float32)
    h1 = daemon.submit("alice", "mandelbrot", [(re, im)] * 3)
    h2 = daemon.submit("bob", "sobel", [(img,)] * 3)
    out1 = h1.future.result(timeout=300)
    out2 = h2.future.result(timeout=300)
    assert len(out1) == 3 and len(out2) == 3
    assert all(o.shape == (256, 256) for o in out1)
    assert all(o.shape == (1024, 1024) for o in out2)
    assert daemon.stats["chunks"] >= 7


def test_module_reuse_avoids_reload(daemon):
    re, im = _mandel_inputs(seed=3)
    before = daemon.stats["reconfigurations"]
    h = daemon.submit("alice", "mandelbrot", [(re, im)] * 4)
    h.future.result(timeout=300)
    assert daemon.stats["reconfigurations"] <= before + 1
    assert daemon.stats["reuses"] > 0


def test_bus_adaptor_pads_and_casts(daemon):
    """Caller sends float64 and a smaller tile; adaptors fix it up."""
    re = np.zeros((200, 256), np.float64)
    im = np.zeros((200, 256), np.float64)
    h = daemon.submit("carol", "mandelbrot", [(re, im)])
    (out,) = h.future.result(timeout=120)
    assert out.shape == (256, 256)
    # zero c never escapes: every pixel counts all 256 iterations
    assert int(out.min()) == 256


def test_failing_chunk_leaves_no_orphaned_state(daemon):
    bad = (np.zeros((512, 512), np.float32),
           np.zeros((512, 512), np.float32))
    h = daemon.submit("erin", "mandelbrot", [bad, bad])
    with pytest.raises(AssertionError):
        h.future.result(timeout=120)
    deadline = time.time() + 30
    while time.time() < deadline:
        with daemon._lock:
            req = daemon.state.requests[h.rid]
            if req.finished and not daemon.state.alloc.busy:
                break
        time.sleep(0.05)
    with daemon._lock:
        assert h.rid not in daemon._results, "orphaned results buffer"
        assert h.rid not in daemon._handles, "orphaned handle"
        req = daemon.state.requests[h.rid]
        assert req.failed and req.finished
        assert not any(r.rid == h.rid for q in daemon.state.queues.values()
                       for r in q), "dead request still queued"
        assert not daemon.state.alloc.busy and not daemon.state.active
    re, im = _mandel_inputs(seed=9)
    h2 = daemon.submit("erin", "mandelbrot", [(re, im)])
    assert len(h2.future.result(timeout=120)) == 1


def test_registry_roundtrip_loads_port_builders(tmp_path):
    reg = default_registry()
    reg.save(tmp_path)
    reg2 = Registry.load(tmp_path)
    assert set(reg2.modules) == set(reg.modules)
    assert reg2.module("mandelbrot").load_builder() is zoo.build_mandelbrot
    assert reg2.module("lm-forward").load_builder() is zoo.build_lm_forward


def _wait_until_busy(d, timeout_s=60.0):
    """Until the scheduler has a chunk in flight on the shell."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with d._lock:
            if d.state.active:
                return
        time.sleep(0.005)
    raise TimeoutError("no chunk was dispatched")


def test_preemption_recipe_resolves_every_chunk_once():
    """A deterministic live preemption: a preemptive 1-slot shell
    saturated by 8 low-priority chunks, then a priority-5 request."""
    shell = _cpu_shell()
    d = Daemon(shell, default_registry(), PolicyConfig(preemptive=True))
    try:
        re, im = _mandel_inputs(seed=0)
        img = np.random.default_rng(2).random((1024, 1024)).astype(
            np.float32)
        lo = d.submit("batch", "mandelbrot", [(re, im)] * 8, priority=0)
        _wait_until_busy(d)
        time.sleep(0.05)
        hi = d.submit("live", "sobel", [(img,)], priority=5)
        (edges,) = hi.future.result(timeout=300)
        outs = lo.future.result(timeout=300)
        assert d.stats["preemptions"] >= 1
        assert len(outs) == 8 and d.stats["chunks"] == 9
        want = run_placement(_place(zoo.build_mandelbrot), re, im)
        for out in outs:
            torch.testing.assert_close(out, want, rtol=0, atol=0)
        torch.testing.assert_close(
            edges, run_placement(_place(zoo.build_sobel), img), rtol=0,
            atol=0)
    finally:
        d.shutdown()


# -- serve_daemon ----------------------------------------------------------


def test_serve_daemon_on_cpu_resolves_every_chunk():
    out = serve_daemon(DaemonServeRun(device="cpu"), log=lambda _: None)
    assert out["stats"]["chunks"] == 14
    handles = out["handles"]["live"] + out["handles"]["batch"]
    assert all(h.future.done() and h.future.exception() is None
               for h in handles)
    assert out["slo_misses"] == 0 and out["live_rejected"] == 0
    assert set(out) >= {"live_p95_ms", "slo_misses", "live_rejected",
                        "wall_s", "stats", "slo", "metrics"}


def test_serve_daemon_contract_counts_add_up():
    out = serve_daemon(DaemonServeRun(device="cpu", contract=True),
                       log=lambda _: None)
    live = out["slo"]["live"]
    assert live["admitted"] + live["degraded"] + live["rejected"] == 6
    rejected = [h for h in out["handles"]["live"]
                if h.future.exception() is not None]
    assert len(rejected) == live["rejected"] == out["live_rejected"]
    for h in rejected:
        with pytest.raises(AdmissionRejected):
            h.future.result()


def test_serve_daemon_trace_out_waits_for_obs(tmp_path):
    """`trace_out` attaches the flight recorder and writes a Chrome trace
    whose chunk counts are the daemon's."""
    path = tmp_path / "t.json"
    out = serve_daemon(DaemonServeRun(device="cpu", trace_out=str(path)),
                       log=lambda _: None)
    trace = json.loads(path.read_text())
    assert trace["traceEvents"]
    counts = out["metrics"]["obs"]["counters"]
    assert counts["chunks_completed"] == out["stats"]["chunks"] == 14
    assert counts["chunks_preempted"] == out["stats"]["preemptions"]
    assert counts["chunks_started"] == (counts["chunks_completed"]
                                        + counts["chunks_preempted"])
