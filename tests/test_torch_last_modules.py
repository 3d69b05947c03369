"""The port's last modules against the JAX package on the CPU, f32 smoke
configs, equal weights through the bridge:

* ``transformer.prefill`` (the one-shot prefill over fresh caches) against
  the reference's on qwen3-4b, gemma2-27b (a 24-token prompt past its
  16-token window: the local layer keeps a ring of 16 rows), whisper-medium
  (its encoder first) and paligemma-3b (an image prefix): last logits
  within atol 1e-4, the tolerance ``tests/test_runtime.py`` holds streamed
  against one-shot to, and every cache leaf of the same shape within 1e-4
  (the zoo tests' model tolerance);
* ``ServingEngine.prefill_streamed`` against the reference's on
  ``tests/test_runtime.py``'s three archs (qwen3-4b, mamba2-2.7b,
  whisper-medium; 32 tokens in chunks of 16): logits and caches within
  1e-4, the position equal;
* ``obs.baseline``: every synthetic case of ``tests/test_obs_baseline.py``
  through both packages' comparators gives the same ``Violation`` tuples;
  ``main`` on files under ``tmp_path`` prints the reference's verdict and
  returns its code; the port's deliberate differences (no ``--run``, each
  baseline path required with its fresh file) raise;
* each example's ``main`` at a tiny size with ``--device cpu`` returns 0,
  and raises without a card when ``--device cpu`` is not given.

One torch thread (the tier-1 run's six workers share the machine)."""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import test_obs_baseline as cases
from repro.models import transformer as RT
from repro.obs import baseline as RB
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.examples import (nw_wavefront, overlap_demo, quickstart, serve_streamed,
                                  train_e2e)
from repro_torch.models import transformer as PT
from repro_torch.obs import baseline as PB
from repro_torch.runtime import serving as PS

LOGIT_TOL = dict(atol=1e-4)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random non-zero values
    (zero at init, so the ``1 + scale`` gain would otherwise go untested)."""
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def fill(t):
        for k, v in t.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "scale":
                t[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
    fill(tree)
    return tree


def _models(arch):
    rcfg, pcfg = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(
        tree, pcfg, device="cpu")


def _inputs(cfg, b, s, seed=1):
    """tokens (B, S) and, as the config wants them, enc_inputs /
    prefix_embeds, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["enc_inputs"] = (0.1 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.prefix_len:
        out["prefix_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    return out


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _same_caches(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].float().numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **MODEL_TOL, err_msg=name)


# -- transformer.prefill ------------------------------------------------------------


def _ref_prefill(cfg, max_seq):
    """The reference's ``prefill``, jitted (one compile, not one an op)."""
    return jax.jit(lambda params, batch: RT.prefill(cfg, params, batch, max_seq=max_seq))


@pytest.mark.parametrize("arch,s", [("qwen3-4b", 20), ("gemma2-27b", 24),
                                    ("whisper-medium", 12), ("paligemma-3b", 10)])
def test_prefill_matches_reference(arch, s):
    rcfg, pcfg, jparams, params = _models(arch)
    b, max_seq = 2, 40
    inputs = _inputs(rcfg, b, s)
    logits_r, caches_r = _ref_prefill(rcfg, max_seq)(
        jparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.inference_mode():
        logits, caches = PT.prefill(pcfg, params,
                                    {k: torch.from_numpy(v) for k, v in inputs.items()},
                                    max_seq=max_seq)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (b, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_r), **LOGIT_TOL)
    _same_caches(caches, caches_r)
    if arch == "gemma2-27b":  # the local layer's ring holds the last 16 positions
        assert s > pcfg.sliding_window
        assert caches["blocks"]["layer0"]["k"].shape[2] == pcfg.sliding_window
        assert caches["blocks"]["layer1"]["k"].shape[2] == max_seq


def test_prefill_sizes_the_cross_state_for_the_encoder_output():
    """whisper's cross K/V rows follow ``enc_inputs``, as the reference's
    ``init_cache(enc_seq=...)``: 12 frames here, not the config's 16."""
    rcfg, pcfg, jparams, params = _models("whisper-medium")
    inputs = _inputs(rcfg, 1, 8)
    inputs["enc_inputs"] = inputs["enc_inputs"][:, :12]
    logits_r, caches_r = _ref_prefill(rcfg, 16)(
        jparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.inference_mode():
        logits, caches = PT.prefill(pcfg, params,
                                    {k: torch.from_numpy(v) for k, v in inputs.items()},
                                    max_seq=16)
    assert caches["blocks"]["layer0"]["cross_k"].shape[2] == 12
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_r), **LOGIT_TOL)
    _same_caches(caches, caches_r)


# -- ServingEngine.prefill_streamed -------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-2.7b", "whisper-medium"])
def test_prefill_streamed_matches_reference(arch):
    rcfg, pcfg, jparams, params = _models(arch)
    b, s = 2, 32
    inputs = _inputs(rcfg, b, s)
    kw = {"enc_inputs": inputs["enc_inputs"]} if "enc_inputs" in inputs else {}
    ref = RS.ServingEngine(rcfg, jparams, RS.ServeConfig(max_seq=s + 8, prefill_chunk=16))
    logits_r, caches_r, pos_r = ref.prefill_streamed(
        jnp.asarray(inputs["tokens"]), **{k: jnp.asarray(v) for k, v in kw.items()})
    eng = PS.ServingEngine(pcfg, params, PS.ServeConfig(max_seq=s + 8, prefill_chunk=16),
                           device="cpu", unembed=PT.unembed_f32(pcfg, params))
    logits, caches, pos = eng.prefill_streamed(torch.from_numpy(inputs["tokens"]), **kw)
    assert pos == pos_r == s
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_r), **LOGIT_TOL)
    _same_caches(caches, caches_r)


# -- obs.baseline -----------------------------------------------------------------


def _set(doc, path, value):
    """A copy of ``doc`` with the entry at ``path`` set to ``value`` (or
    deleted when ``value`` is None)."""
    doc = copy.deepcopy(doc)
    node = doc
    for key in path[:-1]:
        node = node[key]
    if value is None:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return doc


S, O = cases.SERVING, cases.OBS
M = ("modes", 0)
BASELINE_CASES = {  # name -> (comparator, fresh, baseline, keyword arguments)
    "serving-identical": ("compare_serving", S, S, {}),
    "serving-throughput-collapse": (
        "compare_serving", _set(S, ("metrics", "serving_tokens_per_s", "value"), 80.0), S, {}),
    "serving-latency-blowup": (
        "compare_serving", _set(S, ("metrics", "serving_admit_ms_p99", "value"), 450.0), S, {}),
    "serving-jitter-in-band": (
        "compare_serving",
        _set(_set(S, ("metrics", "serving_tokens_per_s", "value"),
                  400.0 * cases.DEFAULT_MIN_RATIO * 1.01),
             ("metrics", "serving_admit_ms", "value"), 30.0 * cases.DEFAULT_MAX_RATIO * 0.99),
        S, {}),
    "serving-missing-metric": (
        "compare_serving", _set(S, ("metrics", "serving_paged_tokens_per_s"), None), S, {}),
    "serving-ungated-ignored": (
        "compare_serving",
        _set(_set(S, ("metrics", "serving_speedup", "value"), 0.1), ("metrics", "tuning_plan"),
             None), S, {}),
    "serving-every-gate-tight-ratios": (
        "compare_serving",
        {"metrics": {k: {"value": v["value"] * 0.9 if "tokens" in k else v["value"] * 1.1}
                     for k, v in S["metrics"].items() if k != "tuning_plan"}},
        S, dict(min_ratio=0.95, max_ratio=1.05)),
    "obs-identical": ("compare_obs", O, O, {}),
    "obs-throughput-latency-overlap": (
        "compare_obs",
        _set(_set(_set(O, M + ("tokens_per_s", "untraced"), 60.0), M + ("itl_ms", "p99"), 90.0),
             M + ("overlap", "measured"), 0.05), O, {}),
    "obs-hard-zeros": (
        "compare_obs", _set(_set(O, M + ("dropped_spans",), 12), M + ("str002_live",), 1), O,
        {}),
    "obs-missing-mode": ("compare_obs", _set(O, ("modes",), []), O, {}),
    "obs-overlap-slack-inside": (
        "compare_obs", _set(O, M + ("overlap", "measured"), 0.55 - 0.34), O, {}),
    "obs-overlap-slack-outside": (
        "compare_obs", _set(O, M + ("overlap", "measured"), 0.55 - 0.36), O, {}),
    "obs-tight-slack-and-ratios": (
        "compare_obs", _set(_set(O, M + ("ttft_ms", "p99"), 85.0), M + ("overlap", "measured"),
                            0.5), O, dict(max_ratio=1.05, overlap_slack=0.01)),
}


@pytest.mark.parametrize("name", BASELINE_CASES)
def test_baseline_comparators_match_reference(name):
    fn, fresh, base, kw = BASELINE_CASES[name]
    want = [dataclasses.astuple(v) for v in getattr(RB, fn)(fresh, base, **kw)]
    got = [dataclasses.astuple(v) for v in getattr(PB, fn)(fresh, base, **kw)]
    assert got == want
    assert PB.render(getattr(PB, fn)(fresh, base, **kw)) == RB.render(
        getattr(RB, fn)(fresh, base, **kw))
    assert (PB.DEFAULT_MIN_RATIO, PB.DEFAULT_MAX_RATIO, PB.DEFAULT_OVERLAP_SLACK,
            PB.SERVING_HIGHER, PB.SERVING_LOWER) == (
        RB.DEFAULT_MIN_RATIO, RB.DEFAULT_MAX_RATIO, RB.DEFAULT_OVERLAP_SLACK,
        RB.SERVING_HIGHER, RB.SERVING_LOWER)


def test_baseline_main_matches_reference(tmp_path, capsys):
    files = {}
    for name, doc in (("s", S), ("o", O),
                      ("s_bad", _set(S, ("metrics", "serving_tokens_per_s", "value"), 1.0)),
                      ("o_bad", _set(O, M + ("str002_live",), 3))):
        files[name] = tmp_path / f"{name}.json"
        files[name].write_text(json.dumps(doc))
    for fresh_s, fresh_o in (("s", "o"), ("s_bad", "o"), ("s", "o_bad"), ("s_bad", "o_bad")):
        argv = ["--serving", str(files[fresh_s]), "--baseline-serving", str(files["s"]),
                "--obs", str(files[fresh_o]), "--baseline-obs", str(files["o"])]
        rc_ref = RB.main(argv)
        out_ref = capsys.readouterr().out
        assert PB.main(argv) == rc_ref == int(fresh_s != "s" or fresh_o != "o")
        assert capsys.readouterr().out == out_ref
    assert PB.main(["--obs", str(files["o_bad"]), "--baseline-obs", str(files["o"])]) == 1
    assert "FAILED" in capsys.readouterr().out
    for argv in ([], ["--run"], ["--obs", str(files["o"])],
                 ["--serving", str(files["s"]), "--baseline-obs", str(files["o"])]):
        with pytest.raises(SystemExit):
            PB.main(argv)


# -- the examples -------------------------------------------------------------------


EXAMPLES = {
    "quickstart": (quickstart, ["--steps", "2"]),
    "train_e2e": (train_e2e, ["--size", "3m", "--steps", "4", "--seq", "32", "--batch", "2"]),
    "serve_streamed": (serve_streamed, ["--prompt-len", "32", "--chunk", "8",
                                        "--new-tokens", "4"]),
    "nw_wavefront": (nw_wavefront, ["--n", "64", "--m", "64"]),
    "overlap_demo": (overlap_demo, ["--small", "--tasks", "2"]),
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    module, argv = EXAMPLES[name]
    if name == "train_e2e":
        argv = argv + ["--ckpt", str(tmp_path / "ckpt")]
    assert module.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    tag = {"serve_streamed": "[serve]", "nw_wavefront": "[nw]", "overlap_demo": "[overlap]",
           "train_e2e": "[e2e]", "quickstart": "[quickstart]"}[name]
    assert tag in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = EXAMPLES[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
