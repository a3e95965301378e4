"""bf16 prefill against teacher-forced decode, in both packages.

A prefill step's cache and last logits should be what decode steps fed
the same prompt leave.  In bf16 the two paths round at different places
(the flash forward against the decode kernel's order, a (B, S) product
against a (B, 1) one), so they drift apart with depth.  This measures
that drift for the reference and the port from the same seeded bf16
weights at a narrow config of 32 layers, as err/tol per layer (max
|prefill - decode| / (2e-2 + 2e-2 |decode|), at most 1 inside the
tolerance of `tests/test_arch_smoke.py:62-78`), and holds the port's to
1.5 times the reference's.

    PYTHONPATH=src python tests/test_torch_bf16_drift.py   # prints both
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import transformer as jtransformer
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer

CPU = torch.device("cpu")
LAYERS, PROMPT, TOL = 32, 64, 2e-2


def configs():
    """llama3-8b's smoke widths (d_model 128, 8 q / 2 kv heads of 16) at
    32 layers, in bf16."""
    over = dict(stages=((LAYERS, jsmoke_config("llama3-8b").stages[0][1]),),
                dtype="bfloat16")
    return (dataclasses.replace(jsmoke_config("llama3-8b"), **over),
            dataclasses.replace(smoke_config("llama3-8b"), **over))


def err_over_tol(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / (TOL + TOL * np.abs(want))).max())


def reference_drift(jcfg, tree, prompt) -> dict:
    logits, caches = jtransformer.forward(tree, jcfg, jnp.asarray(prompt),
                                          return_cache=True)
    cache = jtransformer.init_cache(jcfg, prompt.shape[0], PROMPT)
    step = jax.jit(lambda c, t, p: jtransformer.decode_step(tree, jcfg, c,
                                                            t, p))
    for pos in range(PROMPT):
        last, cache = step(cache, jnp.asarray(prompt[:, pos]),
                           jnp.int32(pos))
    pre, dec = caches[0]["b0"], cache[0]["b0"]    # (L, B, S, KV, hd)
    by_layer = [max(err_over_tol(pre[n][l],
                                 np.swapaxes(np.asarray(dec[n][l],
                                                        np.float32), 1, 2))
                    for n in ("k", "v")) for l in range(LAYERS)]
    return {"kv_by_layer": by_layer,
            "logits": err_over_tol(logits[:, -1], last)}


def port_drift(cfg, params, prompt) -> dict:
    tokens = torch.from_numpy(prompt)
    last_prefill, caches = make_prefill_step(cfg)(params,
                                                  {"tokens": tokens})
    cache = transformer.init_cache(cfg, prompt.shape[0], PROMPT, CPU)
    with torch.no_grad():
        for pos in range(PROMPT):
            last = transformer.decode_step(params, cfg, cache,
                                           tokens[:, pos], pos)
    by_layer = [max(err_over_tol(c[n].float(),
                                 d[n].float().transpose(1, 2))
                    for n in ("k", "v")) for c, d in zip(caches, cache)]
    return {"kv_by_layer": by_layer,
            "logits": err_over_tol(last_prefill.float(), last.float())}


def measure(seed: int = 0) -> dict:
    jcfg, cfg = configs()
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(seed), jcfg))
    params = params_from_reference(tree, cfg, CPU)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    return {"reference": reference_drift(jcfg, tree, prompt),
            "port": port_drift(cfg, params, prompt)}


def test_port_bf16_drift_within_reference():
    m = measure()
    ref, port = m["reference"], m["port"]
    assert len(port["kv_by_layer"]) == LAYERS
    for l, (p, r) in enumerate(zip(port["kv_by_layer"],
                                   ref["kv_by_layer"])):
        assert p <= 1.5 * r, (l, p, r)
    assert port["logits"] <= 1.5 * ref["logits"]


if __name__ == "__main__":
    print(json.dumps(measure()))
