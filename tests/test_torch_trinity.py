"""trinity-mini (afmoe) on the port, held to its plain reference
`src/plain_ref/afmoe.py` (float32, no cache, no kernel).

On the CPU, at `REDUCED` size (8 layers, `ddeFeeeF`, a window of 8, so a
40-token prompt and 12 served tokens wrap each window layer's ring
several times) with seeded weights, on both MoE routes (the one-hot
oracle and the gather): the prefill's logits, prefill then decode through
the ring cache against the reference's full forward, and the cache-free
forward, at logits; then the faults that must fail the comparison (the
window off by one either way, RoPE on a full layer, the gate, a post-norm
or the muP scale left out), the cases that must match bit for bit (a
window at least the sequence equals full causal attention; the ring's
rows and contents), the flash wrapper's window on its plain route, the
spans and counters, the registry, the mesh guard, and two repository
checks: the benchmark's copy of the reference is the reference byte for
byte, and the benchmark runner's window loop, end-to-end metrics and
check are `fosbench/serve_hybrid.py`'s statement for statement.

The `card` tests run the windowed flash kernel against the plain version
at head dim 128, the causal kernel beside it, and a replayed decode step
of trinity against eager steps, bit for bit; they skip without a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_trinity.py -m card
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest

from torch_cpu import torch  # noqa: E402

from plain_ref import afmoe as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch.serve import (ServeRun, generate,  # noqa: E402
                                      serve, serve_inputs)
from repro_torch.models import api, layers, stack  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "trinity-mini"
B, S, NEW = 2, 40, 12
# the port and the reference compute the same fp32 function in another
# order of sums (batched products, the combine's index_add_): they agree
# to ~9e-7 of the logits' largest (measured), so 2e-5 of it leaves room
# for other seeds, while the TF32 control moves them by ~1.6e-3 of it
REL = 2e-5


def _cfg(impl: str, **kw):
    cfg = configs.get(ARCH, reduced=True)
    return dataclasses.replace(
        cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
        kv_dtype=torch.float32, moe=dataclasses.replace(cfg.moe, impl=impl),
        **kw)


def ref_cfg(cfg) -> dict:
    """The reference's config (the published config.json's keys) of a
    port config."""
    pat = cfg.layer_pattern * (cfg.n_layers // len(cfg.layer_pattern))
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "num_hidden_layers": cfg.n_layers,
            "layer_types": ["full_attention" if c == "F"
                            else "sliding_attention" for c in pat],
            "sliding_window": cfg.sliding_window,
            "num_dense_layers": pat.count("d"),
            "num_experts": cfg.moe.n_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "route_scale": cfg.moe.routed_scale,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "mup_enabled": True, "vocab_size": cfg.vocab,
            "capacity_factor": cfg.moe.capacity_factor}


def _params(cfg, seed=0):
    return api.init_params(cfg, torch.Generator().manual_seed(seed))


def _prompt(cfg, n=S, seed=1):
    return torch.randint(0, cfg.vocab, (B, n),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), err


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_prefill_logits_match_the_plain_reference(impl):
    cfg = _cfg(impl)
    params, prompt = _params(cfg), _prompt(cfg)
    with torch.inference_mode():
        _, logits = stack.build_prefill_fn(cfg, S + 1)(
            params, {"tokens": prompt})
        h = ref.final_hidden(params, ref_cfg(cfg), prompt, S)
        want = ref.logits(params, ref_cfg(cfg), h)[:, 0]
    _close(logits[:, :cfg.vocab], want)


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_prefill_then_decode_through_the_ring_matches_the_full_forward(impl):
    """Every served position's logits (the prefill's, then each decode
    step's through the window layers' rings, 12 steps past a window of 8)
    against the reference's forward over the prompt and the served tokens
    fed back; the reference groups the expert layer's calls as the served
    path does (the prompt, then each step's B tokens), so the capacity
    drops the same pairs.  The TF32 control fails the same tolerance."""
    cfg = _cfg(impl)
    params, prompt = _params(cfg), _prompt(cfg)
    toks, logits, _, _ = generate(cfg, params, prompt, NEW)
    seq = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.inference_mode():
        h = ref.final_hidden(params, ref_cfg(cfg), seq, S)
        want = ref.logits(params, ref_cfg(cfg), h)
        hc = ref.final_hidden(params, ref_cfg(cfg), seq, S, ref.Prec("tf32"))
        ctl = ref.logits(params, ref_cfg(cfg), hc, ref.Prec("tf32"))
    assert want.shape == (B, NEW, cfg.vocab)
    _close(logits[..., :cfg.vocab], want)
    with pytest.raises(AssertionError):
        _close(ctl, want)


def _runner():
    import sys
    sys.path.insert(0, str(ROOT))
    from fosbench import serve_afmoe
    return serve_afmoe


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_the_reference_pinned_to_the_served_prefills_choices_matches(impl):
    """The benchmark runner's record of the served prefill's expert choices
    (`_PrefillRoutes`: one [B * S, k] a MoE layer, in the reference's
    order) is what the reference itself chooses: pinned to it, the
    reference takes no choice (none differs) and matches every served
    position's logits."""
    from repro_torch.models import moe
    cfg = _cfg(impl)
    params, prompt = _params(cfg), _prompt(cfg)
    routes = _runner()._PrefillRoutes(moe, stack)
    try:
        toks, logits, _, _ = generate(cfg, params, prompt, NEW)
        pins = routes.take()
        generate(cfg, params, prompt, 2)
        assert len(routes.take()) == len(pins)
    finally:
        routes.restore()
    assert moe.router_probs is routes.orig[0]
    n_moe = sum(1 for _, ffn in cfg.layer_plan()[1] if ffn == "moe") \
        * cfg.layer_plan()[0]
    assert [tuple(p.shape) for p in pins] == [(B * S, cfg.moe.top_k)] * n_moe
    seq = torch.cat([prompt, toks[:, :-1]], dim=1)
    ties: dict = {}
    with torch.inference_mode():
        h = ref.final_hidden(params, ref_cfg(cfg), seq, S, ties=ties,
                             routes=pins)
        want = ref.logits(params, ref_cfg(cfg), h)
    assert ties["pinned"] == ties["route_diff"] == 0
    _close(logits[..., :cfg.vocab], want)


@pytest.mark.parametrize("tie, pinned", [(1e9, True), (0.0, False)])
def test_the_reference_takes_another_runs_choice_only_at_a_near_tie(
        monkeypatch, tie, pinned):
    """Pinned to its own prompt choices the reference is itself, bit for
    bit.  Pinned to choices with one prompt token's moved to other experts
    in every MoE layer, it takes them where that token's own choice sits
    within TIE of a tie (every token, with TIE huge: the output moves,
    and later layers' choices that the moved token changed are taken back
    too) and keeps its own elsewhere (TIE 0: the output is its own, bit
    for bit), counting the token as pinned or as a route that differs."""
    cfg = _cfg("ep")
    params, prompt = _params(cfg), _prompt(cfg)
    rc = ref_cfg(cfg)
    with torch.inference_mode():
        own: list = []
        h0 = ref.final_hidden(params, rc, prompt, S, own=own)
        ties: dict = {}
        assert torch.equal(ref.final_hidden(params, rc, prompt, S, ties=ties,
                                            routes=own), h0)
        assert ties["pinned"] == ties["route_diff"] == 0
        moved = [o.clone() for o in own]
        for o in moved:
            o[3] = (o[3].long() + 1) % cfg.moe.n_experts
            while len(set(o[3].tolist())) < cfg.moe.top_k:
                o[3] = (o[3].long() + 1) % cfg.moe.n_experts
        monkeypatch.setattr(ref, "TIE", tie)
        ties = {}
        h = ref.final_hidden(params, rc, prompt, S, ties=ties, routes=moved)
    n = len(moved)
    if pinned:
        assert ties["pinned"] >= n and ties["route_diff"] == 0
    else:
        assert (ties["pinned"], ties["route_diff"]) == (0, n)
    assert torch.equal(h, h0) is not pinned


def _nodrop(impl, **kw):
    """A config whose experts hold every pair (capacity 64 shares), so a
    forward over all positions at once drops what the reference's
    per-position calls drop: nothing."""
    cfg = _cfg(impl, **kw)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0))


def _forward_logits(cfg, params, seq):
    with torch.inference_mode():
        h, _ = stack.forward(params, cfg, {"tokens": seq})
        return stack.unembed(params, cfg, h)[..., :cfg.vocab]


def _ref_logits(cfg, params, seq):
    with torch.inference_mode():
        h = ref.final_hidden(params, ref_cfg(cfg), seq, 1)
        return ref.logits(params, ref_cfg(cfg), h)


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_cache_free_forward_matches_the_reference(impl):
    """The teacher-forced forward (no cache: the band mask over the whole
    sequence) at every position."""
    cfg = _nodrop(impl)
    params, seq = _params(cfg), _prompt(cfg, n=37)
    _close(_forward_logits(cfg, params, seq), _ref_logits(cfg, params, seq))


def _drop(params, key, within=None):
    """The params without `key` in any sub-layer (or, with `within`, in
    any sub-layer's `within`, as "attn")."""
    def cut(t, inside):
        return {k: cut(v, inside or k == within) if isinstance(v, dict)
                else v for k, v in t.items()
                if k != key or not (inside or within is None)}
    return {**params, "blocks": cut(params["blocks"], False)}


# the port got wrong in one way, against the right reference
FAULTS = {
    "window one short": lambda c, p: (
        dataclasses.replace(c, sliding_window=c.sliding_window - 1), p),
    "window one long": lambda c, p: (
        dataclasses.replace(c, sliding_window=c.sliding_window + 1), p),
    "rope on the full layers": lambda c, p: (
        dataclasses.replace(c, nope_full=False), p),
    "gate left out": lambda c, p: (
        dataclasses.replace(c, attn_gate=False), _drop(p, "w_gate", "attn")),
    "post-attention norm left out": lambda c, p: (c, _drop(p, "ln1_post_w")),
    "post-mlp norm left out": lambda c, p: (c, _drop(p, "ln2_post_w")),
    "muP scale left out": lambda c, p: (
        dataclasses.replace(c, mup_embed=False), p),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_port_fault_fails_the_comparison(fault):
    cfg = _nodrop("ep")
    params, seq = _params(cfg), _prompt(cfg, n=37)
    want = _ref_logits(cfg, params, seq)
    _close(_forward_logits(cfg, params, seq), want)
    bad_cfg, bad_params = FAULTS[fault](cfg, params)
    with pytest.raises(AssertionError):
        _close(_forward_logits(bad_cfg, bad_params, seq), want)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_a_window_as_long_as_the_sequence_is_full_causal(attn_impl):
    """Served with a window at least max_len, the window layers equal
    full causal attention (a window of 0) bit for bit: the prefill's and
    every decode step's logits and tokens."""
    max_len = S + NEW
    out = []
    for w in (max_len, 0):
        cfg = _cfg("ep", sliding_window=w, attn_impl=attn_impl)
        params, prompt = _params(cfg), _prompt(cfg)
        out.append(generate(cfg, params, prompt, NEW)[:2])
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_a_window_layers_cache_is_a_ring_of_its_last_positions():
    """A window layer's K/V hold min(max_len, W) rows, a full layer's
    max_len; after a prefill of S > W positions the first layer's ring
    row p % W holds position p's K/V for the last W positions, bit for
    bit as a full-length cache holds them (a later layer's input depends
    on the windows before it)."""
    cfg = _cfg("ep")
    w = cfg.sliding_window
    assert [tuple(c["k"].shape)[2] for c in
            stack.init_cache(cfg, B, 5, "cpu").values()] == [5] * 8
    cache = stack.init_cache(cfg, B, S + NEW, "cpu")
    rows = {n: c["k"].shape[2] for n, c in cache.items()}
    assert rows == {f"sub{i}": (S + NEW if c == "F" else w)
                    for i, c in enumerate(cfg.layer_pattern)}
    params, prompt = _params(cfg), _prompt(cfg)
    with torch.inference_mode():
        ring, _ = stack.build_prefill_fn(cfg, S + NEW)(
            params, {"tokens": prompt})
        whole, _ = stack.build_prefill_fn(
            dataclasses.replace(cfg, sliding_window=S + NEW), S + NEW)(
            params, {"tokens": prompt})
    pos = torch.arange(S - w, S)
    for kv in ("k", "v"):
        assert torch.equal(ring["sub0"][kv][:, :, pos % w],
                           whole["sub0"][kv][:, :, pos])


def test_the_band_mask_on_every_plain_route():
    """`_attend`'s plain routes (one `_sdpa`, the q-block loop of
    `_chunked_sdpa`) and the flash wrapper's plain route apply the same
    band: query i sees keys i - W < j <= i."""
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(2, 29, 4, 16, generator=gen)
    k, v = (torch.randn(2, 29, 2, 16, generator=gen) for _ in range(2))
    spec = layers.AttentionSpec(n_heads=4, n_kv_heads=2, head_dim=16,
                                window=6)
    want = fa_ops.flash_attention_plain(q, k, v, window=6)
    # by hand: query 20 sees keys 15..20 only
    kr, vr = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    sc = torch.einsum("hd,khd->hk", q[0, 20], kr[0, 15:21]) * 16 ** -0.5
    byhand = torch.einsum("hk,khd->hd", sc.softmax(-1), vr[0, 15:21])
    torch.testing.assert_close(want[0, 20], byhand, rtol=1e-5, atol=1e-6)
    for s in (spec, dataclasses.replace(spec, attn_chunk=8)):
        for impl in ("xla", "pallas"):
            got = layers._attend(q, k, v, s, impl, causal=True)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    full = fa_ops.flash_attention_plain(q, k, v)
    assert not torch.allclose(full, want)
    assert torch.equal(fa_ops.flash_attention_plain(q, k, v, window=29),
                       full)


@pytest.mark.parametrize("kw,err", [
    ({"window": -1}, ValueError), ({"window": 4, "causal": False},
                                   ValueError),
    ({"window": 2.5}, ValueError)])
def test_the_flash_wrapper_names_the_windows_limits(kw, err):
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(err):
        fa_ops.flash_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa_ops.flash_attention(q, q[:, :4], q[:, :4], window=4)


@pytest.mark.parametrize("pattern,n_win,n_full", [
    ("ddeFeeeF", 6, 2), ("ddeF" + "eeeF" * 3, 12, 4)])
def test_spans_and_counters_of_the_window_layers(pattern, n_win, n_full):
    """On the kernel route a recorded prefill counts one `attn.window_flash`
    a window layer and one `attn.prefill_flash` a full layer (12 and 4 for
    the served 16 layers' pattern), and opens an `attn.window` span inside
    each window layer's `layer.attn`; an eager decode step opens one
    there too (the ring read)."""
    cfg = _cfg("ep", attn_impl="pallas", layer_pattern=pattern,
               n_layers=len(pattern))
    params, prompt = _params(cfg), _prompt(cfg)
    with spans.recorder(device=False) as rec:
        generate(cfg, params, prompt, 2)
    assert rec["counters"]["prefill"]["attn.window_flash"] == n_win
    assert rec["counters"]["prefill"]["attn.prefill_flash"] == n_full
    parent = {r["id"]: r["name"] for r in rec["spans"]}
    win = [r for r in rec["spans"] if r["name"] == "attn.window"]
    assert all(parent[r["parent"]] == "layer.attn" for r in win)
    assert sum(r["step"] == -1 for r in win) == n_win
    assert sum(r["step"] == 0 for r in win) == n_win


def test_the_registry_and_the_launcher_serve_it():
    """`configs.get` resolves it (full and reduced) while `ARCH_IDS` stays
    the reference's ten; the full config is the published 32 layers (24
    window, 8 full; 2 dense, 30 MoE) and 26.12 B parameters; the served
    entry point runs the reduced config."""
    assert len(configs.ARCH_IDS) == 10 and ARCH not in configs.ARCH_IDS
    assert ARCH in configs.PORT_ARCH_IDS
    full = configs.get(ARCH)
    n_groups, plan = full.layer_plan()
    assert n_groups == 1 and len(plan) == 32
    mixers, ffns = zip(*plan)
    assert (mixers.count("swa"), mixers.count("attn")) == (24, 8)
    assert (ffns.count("dense"), ffns.count("moe")) == (2, 30)
    assert round(api.param_count(full) / 1e9, 2) == 26.12
    assert full.mixer_spec("swa").window == 2048
    assert full.mixer_spec("swa").use_rope
    assert not full.mixer_spec("attn").use_rope
    assert full.mixer_spec("attn").window == 0
    out = serve(ServeRun(arch=ARCH, batch=B, prompt_len=20,
                         max_new_tokens=3, device="cpu", attn_impl="xla"),
                log=lambda *a: None)
    assert out["tokens"].shape == (B, 3)


def test_a_window_under_a_mesh_raises():
    """No mesh path holds a ring: a window layer under a mesh raises rather
    than attend over the whole prefix."""
    spec = layers.AttentionSpec(n_heads=2, n_kv_heads=1, head_dim=16,
                                window=4)
    with pytest.raises(NotImplementedError, match="mesh"):
        layers.attention({}, torch.zeros(1, 4, 32), spec, torch.arange(4),
                         mesh=object())


def test_the_reference_imports_only_torch():
    tree = ast.parse((ROOT / "src" / "plain_ref" / "afmoe.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods == {"__future__", "torch", "torch.nn.functional"}, mods


def test_the_benchmark_copy_of_the_reference_is_the_reference():
    assert (ROOT / "fosbench" / "reference_afmoe.py").read_bytes() \
        == (ROOT / "src" / "plain_ref" / "afmoe.py").read_bytes()


def _functions(path: Path) -> dict:
    tree = ast.parse(path.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


class _Swap(ast.NodeTransformer):
    """The afmoe family module's name put back to the hybrid's."""

    def visit_Name(self, node):
        if node.id == "afmoe":
            node.id = "hybrid"
        return node


def _statements(fn) -> list[tuple[str, str]]:
    """(what it sets or tests, its syntax tree) of each statement."""
    out = []
    for s in fn.body:
        head = (s.targets[0] if isinstance(s, ast.Assign)
                else getattr(s, "test", None))
        name = getattr(head, "id", None) or getattr(
            getattr(head, "elts", [None])[0], "id", "")
        out.append((name, ast.dump(_Swap().visit(s))))
    return out


class _Unpin(ast.NodeTransformer):
    """serve_afmoe's additions taken out: the recorded prefill choices
    (`routes`, `pins`) and the reference's pinning to them (`own`,
    `n_pin`, `n_diff` and the dictionary entries they fill)."""
    NAMES = {"routes", "pins", "own", "n_pin", "n_diff"}

    def _uses(self, node):
        return any(isinstance(n, ast.Name) and n.id in self.NAMES
                   or isinstance(n, ast.arg) and n.arg in self.NAMES
                   or isinstance(n, ast.keyword) and n.arg in self.NAMES
                   or isinstance(n, ast.Constant)
                   and n.value in ("pinned", "route_diff")
                   for n in ast.walk(node))

    def generic_visit(self, node):
        super().generic_visit(node)
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list):
                setattr(node, field, [
                    st for st in stmts if not (
                        isinstance(st, (ast.Assign, ast.AnnAssign,
                                        ast.AugAssign, ast.Expr))
                        and self._uses(st) and not self._keeps(st))])
        return node

    def _keeps(self, st):
        """The reference's calls (`h`, `hc`) stay, less their pinning
        arguments."""
        return isinstance(st, ast.Assign) and not any(
            isinstance(n, ast.Name) and n.id in self.NAMES
            for t in st.targets for n in ast.walk(t))


def _unpinned(fn):
    fn = _Unpin().visit(ast.parse(ast.unparse(fn)).body[0])
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords
                             if k.arg not in ("own", "routes")]
            node.args = [a for a in node.args if not (
                isinstance(a, ast.Name) and a.id in _Unpin.NAMES)]
        if isinstance(node, ast.ImportFrom):      # the recorder's module
            node.names = [a for a in node.names if a.name != "moe"]
        if isinstance(node, ast.Dict):
            keep = [(k, v) for k, v in zip(node.keys, node.values)
                    if not (isinstance(k, ast.Constant)
                            and k.value in ("pinned", "route_diff"))]
            node.keys, node.values = [k for k, _ in keep], [v for _, v in keep]
        if isinstance(node, ast.arguments):
            pos = [a for a in node.args if a.arg not in _Unpin.NAMES]
            node.defaults = node.defaults[len(node.defaults)
                                          - (len(node.args) - len(pos))
                                          or len(node.defaults):] \
                if len(pos) < len(node.args) else node.defaults
            node.args = pos
    return fn


def test_the_afmoe_runner_is_serve_hybrid_statement_for_statement():
    """`fosbench/serve_afmoe.py`'s `run` and `_check` are
    `serve_hybrid`'s, and its `_run`'s set-up, warm-up, window loop and
    end-to-end metrics are `serve_hybrid._run`'s, apart from the family
    module (its traced part profiles the prefill alone, with the windowed
    kernel's launches, and its ctx holds no decode profile) and from the
    record of each prefill's expert choices that the reference is pinned
    to at its near-ties (`_Unpin` takes it out; the control's reference
    call comes first, so its own choices can pin the fp32 one)."""
    hyb = _functions(ROOT / "fosbench" / "serve_hybrid.py")
    afm = {k: _unpinned(v) for k, v in
           _functions(ROOT / "fosbench" / "serve_afmoe.py").items()}
    ca, cb = afm["_check"], hyb["_check"]
    loop_a = next(n for n in ca.body if isinstance(n, ast.For))
    loop_b = next(n for n in cb.body if isinstance(n, ast.For))
    with_a, with_b = loop_a.body[-1], loop_b.body[-1]
    # the no_grad block: the two reference calls swapped, the rest equal
    sa, sb = with_a.body, with_b.body
    assert ast.dump(sa[1]) == ast.dump(sb[2])       # the control's
    assert ast.dump(sa[2]) == ast.dump(sb[1])       # the reference's
    assert [ast.dump(x) for x in sa[:1] + sa[3:]] == \
        [ast.dump(x) for x in sb[:1] + sb[3:]]
    with_a.body = sb
    for fn in (ca, cb):         # the docstrings say what each adds
        fn.body = fn.body[1:]
    assert ast.dump(ca) == ast.dump(cb)
    assert ast.dump(afm["run"]) == ast.dump(hyb["run"])
    a, b = _statements(afm["_run"]), _statements(hyb["_run"])
    assert [x for x, _ in a] == [y for y, _ in b]
    diff = [x for (x, ta), (_, tb) in zip(a, b) if ta != tb]
    assert diff == ["profile", "trace", "ctx"], diff
    assert any(t.startswith("While(") for _, t in a)


def test_the_benchmark_table_is_the_ports_param_tree():
    """The harness's weight table for the cell's configuration has every
    leaf of the port's param table at its shape, and its window work at
    a window past the sequence is the causal flash work."""
    from fosbench import afmoe, common, counts
    cfg = common.config("trinity-mini-16l")
    table = afmoe.table(cfg)
    port = dict(api.flatten(api.param_table(afmoe.port_config(cfg))))
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: s for k, (s, _) in table.items()}
    assert afmoe.flash_window_work(2, 1000, 1000, 32, 4, 128) == \
        counts.flash_work(2, 1000, 32, 4, 128)
    m = afmoe.dims(cfg)
    assert (m["window_layers"], m["full_layers"]) == (12, 4)
    assert round(afmoe.prefill_flops(m, 2, 16384) / 1e12, 1) == 115.7


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stack.release_decode_graphs()
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("w", [2048, 100])
@pytest.mark.parametrize("s", ["w-1", 4096, 9088])
def test_card_windowed_flash_kernel_against_the_plain_version(s, w):
    """fp32 at head dim 128, 8 q heads on one kv head: the windowed kernel
    within 2e-5 of the plain version (the causal kernel's own tolerance),
    and a window past the sequence equal to the causal kernel."""
    dev = _card()
    s = w - 1 if s == "w-1" else s
    gen = torch.Generator(device=dev).manual_seed(s + w)
    q = torch.randn((1, s, 8, 128), generator=gen, device=dev)
    k, v = (torch.randn((1, s, 1, 128), generator=gen, device=dev)
            for _ in range(2))
    with torch.inference_mode():
        got = fa_ops.flash_attention(q, k, v, window=w)
        want = fa_ops.flash_attention_plain(q, k, v, window=w)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        causal = fa_ops.flash_attention(q, k, v)
        torch.testing.assert_close(
            causal, fa_ops.flash_attention_plain(q, k, v),
            atol=2e-5, rtol=2e-5)
        assert torch.equal(fa_ops.flash_attention(q, k, v, window=s),
                           causal)


@pytest.fixture
def _deterministic(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.card
def test_card_replayed_trinity_step_equals_eager_steps(_deterministic):
    """Trinity's graphed decode step (one eager step, a capture, then
    replays; the ring slot and its length computed on the device) gives
    every step's tokens and logits and the final cache of eager steps on
    a Python int, bit for bit, past several wraps of the rings."""
    dev = _card()
    cfg, params, prompt, extra = serve_inputs(
        ServeRun(arch=ARCH, batch=B, prompt_len=S, max_new_tokens=NEW,
                 device="cuda", attn_impl="pallas"), dev)
    decode = stack.build_decode_fn(cfg)
    with torch.inference_mode(), spans.recorder(device=True) as rec:
        cache, logits = stack.build_prefill_fn(cfg, S + NEW)(
            params, {**extra, "tokens": prompt})
        twin = tree_mod.tree_map(lambda t: t.clone(), cache)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        for i in range(NEW - 1):
            cache, nxt, lg = decode(params, cache, tok, S + i)
            want = stack._decode_step(params, cfg, twin, tok, S + i)
            assert torch.equal(nxt, want[0]) and torch.equal(lg, want[1])
            tok = want[0][:, None]
    torch.cuda.synchronize(dev)
    assert all(torch.equal(x, y) for x, y in zip(tree_mod.leaves(cache),
                                                 tree_mod.leaves(twin)))
    counts = rec["counters"]["other"]
    assert counts["serve.decode_graph.captures"] == 1
    assert counts["serve.decode_graph.replays"] == NEW - 2
