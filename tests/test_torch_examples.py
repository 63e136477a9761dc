"""The port's examples (`repro_torch.examples`) on the CPU.

Each example's `main(["--device", "cpu"])` runs in a temporary working
directory and what it prints is checked:

- `fos_registry_tour`: Listings 1 and 2 are the JSON the reference's
  `examples/fos_registry_tour.py` prints (Listing 2's entrypoint renamed
  `repro.` -> `repro_torch.`), the cache hits and the tile's shape are
  its, the mean escape iteration equals the reference's exactly, and the
  module signature is the same JSON;
- `multi_tenant_serving`: every line that does not depend on timing is
  the reference example's on the CPU (its one-device view: one shell):
  the fabric line, each tenant's chunk count and output shape, erin's
  admission verdict, her submitted / admitted / degraded / rejected
  counts and the flight recorder's;
- `elastic_train` (reduced, default steps) and `quickstart`: the
  reference's train path is red on this jax (the sharded step raises
  `ShardingTypeError`; `tests/test_substrates.py::test_train_*`), so
  these two are held to their own invariants, not to the reference's
  run: one restart, one elastic switch and every step taken; a finite
  training loss that falls and 16 served tokens.
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
from pathlib import Path

import numpy as np

from torch_cpu import torch  # noqa: E402

from repro_torch.examples import elastic_train, fos_registry_tour  # noqa: E402
from repro_torch.examples import multi_tenant_serving, quickstart  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _reference_example(name: str):
    """The reference's `examples/<name>.py` as a module (it imports jax
    and `repro`)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, capsys, argv=None):
    out = main() if argv is None else main(argv)
    return out, capsys.readouterr().out


def _sections(text: str) -> dict:
    """The tour's output by its "== title ==" headings."""
    parts = re.split(r"^== (.+) ==$", text, flags=re.M)
    return {parts[i]: parts[i + 1].strip() for i in range(1, len(parts), 2)}


def test_fos_registry_tour_prints_the_reference_listings(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    monkeypatch.chdir(tmp_path)
    got, text = _run(fos_registry_tour.main, capsys, ["--device", "cpu"])
    _, ref_text = _run(_reference_example("fos_registry_tour").main, capsys)
    mine, ref = _sections(text), _sections(ref_text)
    assert list(mine) == list(ref)
    listing1 = "shell descriptor (paper Listing 1)"
    listing2 = "accelerator descriptor (paper Listing 2)"
    assert mine[listing1] == ref[listing1]
    assert json.loads(mine[listing2]) == json.loads(
        ref[listing2].replace('"repro.', '"repro_torch.'))
    compile_ = "decoupled compilation against the slot interface"
    hits = re.compile(r"cache_hit=(\w+)")
    assert hits.findall(mine[compile_]) == hits.findall(ref[compile_]) == \
        ["False", "True"]
    driver = "generic driver invocation (paper Listings 4/5)"
    assert mine[driver] == ref[driver]
    # the escape counts equal the reference's on the CPU, so the mean too
    from repro.core import Shell as RefShell, default_registry, \
        uniform_shell
    from repro.core.module import AccelModule, run_placement
    desc = default_registry().module("mandelbrot")
    mod = AccelModule("mandelbrot", desc.load_builder(), desc.footprints)
    pl = mod.place(RefShell(uniform_shell("host1_s1", (1, 1), 1)).slots[0],
                   1)
    rng = np.random.default_rng(0)
    re_t = rng.uniform(-2, 1, (256, 256)).astype(np.float32)
    im_t = rng.uniform(-1.5, 1.5, (256, 256)).astype(np.float32)
    want = np.asarray(run_placement(pl, re_t, im_t))
    np.testing.assert_array_equal(got["escape"], want)
    assert float(got["escape"].mean()) == float(want.mean())
    sig = "module I/O signature (the ADR-map analogue)"
    assert mine[sig] == ref[sig]
    assert got["signature"] == json.loads(json.dumps(
        mod.program(pl.slot, 1).signature()))


def _steady_lines(text: str) -> list:
    """The lines of a multi-tenant run that do not depend on timing: the
    fabric line, each tenant's chunk count and output shape, erin's
    verdict and counts, the recorder's admission counts."""
    out = []
    for line in text.splitlines():
        if line.startswith("fabric:"):
            out.append(line)
        elif re.match(r"  \w+/[\w-]+: ", line):
            out.append(re.sub(r" at t=[\d.]+s", "", line))
        elif line.startswith("erin/sobel admission:"):
            out.append(line.split(" (")[0])
        elif line.startswith("slo  :"):
            out.append(line.split(" attainment=")[0])
        elif line.startswith("obs  :"):
            out.append(line.split(" chunks=")[0])
    return out


def test_multi_tenant_serving_prints_the_reference_run(tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    got, text = _run(multi_tenant_serving.main, capsys, ["--device", "cpu"])
    assert (tmp_path / "trace.json").exists()
    (tmp_path / "trace.json").unlink()
    _, ref_text = _run(_reference_example("multi_tenant_serving").main,
                       capsys)
    mine, ref = _steady_lines(text), _steady_lines(ref_text)
    assert len(mine) == 10, text
    assert mine == ref
    assert "erin/sobel admission: DEGRADE -> 'sobel-lite'" in mine
    assert got["obs"]["submitted"] == 7


def test_elastic_train_restarts_and_switches_once(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.chdir(tmp_path)
    hist, text = _run(elastic_train.main, capsys, ["--device", "cpu"])
    assert hist["restarts"] == 1
    assert hist["elastic_switches"] == 1
    assert hist["final_step"] == 40
    assert "done: steps=40 restarts=1 elastic_switches=1" in text


def test_quickstart_trains_and_serves(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out, text = _run(quickstart.main, capsys, ["--device", "cpu"])
    losses = [loss for _, loss in out["train"]["loss"]]
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert out["serve"]["tokens"].shape == (2, 16)
    assert "== serving llama3.2-3b (reduced): prefill + 16 tokens ==" in text
