"""Attention split by whole heads, the MoE oracle under a mesh, and
sequence parallelism under "train", on gloo ranks against one device.

1. `layers.head_split`, the rule that gives each "model" rank its whole
   q and kv heads whatever the counts: the cases of the rule, and the
   heads a rank holds at model = 16 for every config.
2. One spawn of `tests/torch_ranks.py job_split` on 8 ranks runs every
   case below; each test asserts a part of its results against the
   port's unsharded run of the same weights and inputs (loss 1e-5 and
   grads 1e-4 relative L2 for a train step, logits 1e-5 relative max):
   - attention split by the rule: a dense variant with 6 q / 2 kv heads
     on model = 4 (a kv head's 3 q heads over 2 ranks: 2 and 1), reduced
     llama3.2-3b's 4 / 2 on model = 4 (each kv head on 2 ranks), and a
     5-head MHA variant on model = 2 (the groups dealt 3 and 2), each
     under "train" (one step) and "serve" (prefill and decode on the
     sequence-sharded cache);
   - the MoE oracle ("dense") under a mesh: reduced qwen3-moe-30b-a3b's
     train step and serving on the (2, 4) mesh, and `launch.serve.serve`
     over the 8 ranks on the plain route (which maps to the oracle);
   - sequence parallelism under "train": between sub-layers a rank holds
     S / n rows, and the step of reduced llama3.2-3b, qwen3-moe (the
     expert-parallel route) and jamba-v0.1-52b (SSM and MoE) equals one
     device's.
The weights are the port's init of each config plus Gaussian noise
(std 0.05) on every leaf but a_log and dt_bias, so biases and norm
weights are not their constant init; drawn from a seeded CPU generator.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import ServeRun, serve  # noqa: E402
from repro_torch.models import api, layers, stack  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TIGHT = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S_TRAIN, S_PROMPT, NEW = 4, 32, 16, 4
MESH_24 = [[2, 4], ["data", "model"]]
MESH_42 = [[4, 2], ["data", "model"]]

# ---------------------------------------------------------------------------
# 1. the rule
# ---------------------------------------------------------------------------

RULE_CASES = [
    # (H, K, n): each rank's (q0, q1, k0, k1), or None (computes whole)
    (8, 8, 4, [(0, 2, 0, 2), (2, 4, 2, 4), (4, 6, 4, 6), (6, 8, 6, 8)]),
    (6, 2, 4, [(0, 2, 0, 1), (2, 3, 0, 1), (3, 5, 1, 2), (5, 6, 1, 2)]),
    (4, 2, 4, [(0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 1, 2), (3, 4, 1, 2)]),
    (5, 5, 2, [(0, 3, 0, 3), (3, 5, 3, 5)]),
    (12, 4, 3, [(0, 6, 0, 2), (6, 9, 2, 3), (9, 12, 3, 4)]),
    (4, 2, 8, None),        # 2 q heads a kv head over 4 ranks
    (6, 3, 4, None),        # 4 ranks, 3 kv heads: neither divides
    (8, 8, 16, None),       # MHA over more ranks than heads
]


@pytest.mark.parametrize("h,k,n,want", RULE_CASES)
def test_head_split_rule(h, k, n, want):
    assert layers.head_split(h, k, n) == want


# heads a rank holds at model = 16: (q heads most, fewest; kv heads a rank)
TABLE_16 = {
    "llama3.2-3b": (2, 1, 1), "qwen3-14b": (3, 2, 1),
    "granite-3-8b": (2, 2, 1), "phi3.5-moe-42b-a6.6b": (2, 2, 1),
    "jamba-v0.1-52b": (2, 2, 1), "yi-9b": (2, 2, 1),
    "qwen3-moe-30b-a3b": (2, 2, 1), "whisper-large-v3": (2, 1, None),
    "phi-3-vision-4.2b": (2, 2, 2),
}


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get(a).n_heads])
def test_head_split_at_model_16(arch):
    """Every attention arch in `configs/` splits over 16 "model" ranks by
    whole heads (none falls back to computing whole); rank 0 holds the
    most; every q head sits beside its kv head, once, and every kv head
    on some rank.  The heads a rank holds are the table's."""
    cfg = configs.get(arch)
    h, k = cfg.n_heads, cfg.n_kv_heads
    split = layers.head_split(h, k, 16)
    assert split is not None
    g = h // k
    qs = [q1 - q0 for q0, q1, _, _ in split]
    kvs = [k1 - k0 for _, _, k0, k1 in split]
    assert qs[0] == max(qs) and kvs[0] == max(kvs)
    assert [q for q0, q1, _, _ in split for q in range(q0, q1)] == \
        list(range(h))
    assert {kv for _, _, k0, k1 in split for kv in range(k0, k1)} == \
        set(range(k))
    for q0, q1, k0, k1 in split:
        assert all(k0 <= q // g < k1 for q in range(q0, q1))
    most, fewest, kv = TABLE_16[arch]
    assert (max(qs), min(qs)) == (most, fewest)
    if kv is None:      # MHA: the kv heads are the q heads
        assert kvs == qs == [2] * 4 + [1] * 12
    else:
        assert set(kvs) == {kv}


# ---------------------------------------------------------------------------
# 2. one spawn of 8 gloo ranks
# ---------------------------------------------------------------------------

CASES = [
    dict(name="dense62", arch="llama3.2-3b",
         over=dict(n_heads=6, n_kv_heads=2), mesh=MESH_24,
         kinds=["train", "serve"]),
    dict(name="llama", arch="llama3.2-3b", mesh=MESH_24,
         kinds=["train", "serve"]),
    dict(name="mha5", arch="llama3.2-3b",
         over=dict(n_heads=5, n_kv_heads=5), mesh=MESH_42,
         kinds=["train", "serve"]),
    dict(name="moe_dense", arch="qwen3-moe-30b-a3b", moe=dict(impl="dense"),
         mesh=MESH_24, kinds=["train", "serve"]),
    # the expert-parallel route's aux loss is, under a mesh, the mean of
    # each batch shard's own (the reference's `moe_ep`), not the global
    # batch's: held at 5e-3 in test_torch_distribution.py, it is weighted
    # 0 here, so that the rest of the step is held at 1e-5
    dict(name="moe_ep", arch="qwen3-moe-30b-a3b",
         moe=dict(impl="ep", capacity_factor=8.0, aux_loss_weight=0.0),
         mesh=MESH_24, kinds=["train"]),
    dict(name="jamba", arch="jamba-v0.1-52b",
         moe=dict(impl="ep", capacity_factor=8.0, aux_loss_weight=0.0),
         mesh=MESH_24, kinds=["train"]),
]
C8_CASES = ["dense62", "llama", "mha5"]
SERVE_DRIVER = dict(arch="qwen3-moe-30b-a3b", batch=2, prompt_len=12,
                    max_new_tokens=4, device="cpu", attn_impl="xla")


def _params_np(cfg, seed: int) -> dict:
    params = api.init_params(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in api.flatten(params):
        a = leaf.float().numpy()
        if path.split("/")[-1] not in ("a_log", "dt_bias"):
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        out[path] = a
    return api.unflatten(out.items())


def _inputs(cfg, seed: int) -> dict:
    rng = np.random.default_rng(100 + seed)
    return {"train_tokens": rng.integers(0, cfg.vocab, (B, S_TRAIN),
                                         dtype=np.int32),
            "prompt": rng.integers(0, cfg.vocab, (B, S_PROMPT),
                                   dtype=np.int32)}


def _tensors(tree):
    return tree_mod.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _one_device_step(cfg, params_np, tokens):
    params = _tensors(params_np)
    seen = []
    real_update = adamw.update

    def spy(opt_cfg, grads, opt_state, params):
        seen.append(tree_mod.tree_map(lambda g: g.clone(), grads))
        return real_update(opt_cfg, grads, opt_state, params)
    step = steps.build_train_step(cfg, adamw.AdamWConfig(**OPT))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(adamw, "update", spy)
        _, metrics = step({"params": params, "opt": adamw.init(params)},
                          {"tokens": torch.from_numpy(tokens)})
    return float(metrics["loss"]), float(metrics["grad_norm"]), seen[0]


def _one_device_serve(cfg, params_np, prompt):
    params = _tensors(params_np)
    b, s = prompt.shape
    with torch.inference_mode():
        cache, logits = stack.build_prefill_fn(cfg, max_len=s + NEW)(
            params, {"tokens": torch.from_numpy(prompt)})
        got = [logits]
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        decode = stack.build_decode_fn(cfg)
        for i in range(NEW - 1):
            cache, nxt, logits = decode(params, cache, tok, s + i)
            got.append(logits)
            tok = nxt[:, None]
    return torch.stack(got, 1).numpy()


@pytest.fixture(scope="module")
def split_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("split")
    one = {}
    for seed, case in enumerate(CASES):
        cfg = torch_ranks.case_cfg(case)
        params, io_np = _params_np(cfg, seed), _inputs(cfg, seed)
        torch_ranks.save_tree(work / f"{case['name']}_params.npz", params)
        torch_ranks.save_tree(work / f"{case['name']}_io.npz", io_np)
        if "train" in case["kinds"]:
            one[case["name"], "train"] = _one_device_step(
                cfg, params, io_np["train_tokens"])
        if "serve" in case["kinds"]:
            one[case["name"], "serve"] = _one_device_serve(
                cfg, params, io_np["prompt"])
    cases = [dict(c, new=NEW) for c in CASES]
    cases.append(dict(name="serve_driver", serve_driver=SERVE_DRIVER))
    (work / "split.json").write_text(json.dumps({"cases": cases,
                                                 "opt": OPT}))
    ranks = torch_ranks.run("split", 8, work)
    one["serve_driver"] = serve(ServeRun(**SERVE_DRIVER),
                                log=lambda *_: None)["logits"].numpy()
    return ranks, one


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _check_step(split_run, name):
    ranks, one = split_run
    loss, gnorm, grads = one[name, "train"]
    want = dict(tree_mod.leaves_with_paths(grads))
    for r in ranks:
        got = r[f"{name}/train"]
        assert abs(got["loss"] - loss) <= TIGHT * abs(loss)
        assert abs(got["grad_norm"] - gnorm) <= TIGHT * abs(gnorm)
        for path, g in tree_mod.leaves_with_paths(got["grads"]):
            assert _rel_l2(g.numpy(), want[path].numpy()) <= 1e-4, path


def _check_serve(split_run, name):
    ranks, one = split_run
    want = one[name] if name == "serve_driver" else one[name, "serve"]
    for r in ranks:
        got = r[f"{name}/serve_logits"].numpy()
        assert got.shape == want.shape
        assert _rel_max(got, want) <= TIGHT
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", C8_CASES)
def test_split_attention_train_step_matches_one_device(name, split_run):
    _check_step(split_run, name)


@pytest.mark.parametrize("name", C8_CASES)
def test_split_attention_serving_matches_one_device(name, split_run):
    """Prefill and three decode steps on the cache sharded over the
    "model" ranks' rows (20 rows: the update-inside body)."""
    _check_serve(split_run, name)


@pytest.mark.parametrize("name", C8_CASES)
def test_rank_computes_with_its_heads(name, split_run):
    """Rank 0 computes attention with its heads' columns of wq/wk/wv and
    rows of wo, under the "model" axis (not whole)."""
    ranks, _ = split_run
    case = next(c for c in CASES if c["name"] == name)
    cfg = torch_ranks.case_cfg(case)
    n = case["mesh"][0][1]
    q0, q1, k0, k1 = layers.head_split(cfg.n_heads, cfg.n_kv_heads, n)[0]
    hd, d = cfg.head_dim, cfg.d_model
    used = ranks[0][f"{name}/attn_used"]
    assert ranks[0][f"{name}/tp"]["attn"] == ("model",)
    assert used["wq"] == (d, (q1 - q0) * hd)
    assert used["wk"] == used["wv"] == (d, (k1 - k0) * hd)
    assert used["wo"] == ((q1 - q0) * hd, d)


def test_moe_oracle_train_step_under_a_mesh(split_run):
    """qwen3-moe on the "dense" route over the (2, 4) mesh: the oracle
    runs over the batch gathered from the "data" ranks, so its capacity
    and queues are the unsharded run's, and so are loss and grads."""
    _check_step(split_run, "moe_dense")


def test_moe_oracle_serving_under_a_mesh(split_run):
    _check_serve(split_run, "moe_dense")


def test_serve_driver_runs_the_moe_oracle_over_the_ranks(split_run):
    """`serve` over 8 ranks of qwen3-moe on the plain route (moe "dense"):
    its logits are the one-process `serve`'s."""
    _check_serve(split_run, "serve_driver")


@pytest.mark.parametrize("name", ["llama", "moe_ep", "jamba", "dense62",
                                  "mha5"])
def test_sequence_parallel_rows_between_layers(name, split_run):
    """Under "train" every sub-layer takes this rank's S / n rows of the
    residual stream ("seq" -> "model")."""
    ranks, _ = split_run
    n = next(c for c in CASES if c["name"] == name)["mesh"][0][1]
    for r in ranks:
        rows = r[f"{name}/train"]["rows"]
        assert rows and set(rows) == {S_TRAIN // n}


@pytest.mark.parametrize("name", ["llama", "moe_ep", "jamba"])
def test_sequence_parallel_train_step_matches_one_device(name, split_run):
    _check_step(split_run, name)
