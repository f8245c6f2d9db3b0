"""The chunked two-pass training attention against the JAX package's.

``chunked_masked_meanshift_attention_twopass`` at K = 200 keys in chunks of
64 (the JAX side pads the last chunk with 56 masked keys; the port's last
chunk is shorter), with guard rows (queries whose every key is masked):
forward within 1e-5 and the gradients of the query, key, value and every
projection within 1e-4 of JAX's, on the same random cotangent. Also the
decoder's switch: the chunked form from CHUNKED_ATTENTION_MIN_K keys on, the
dense masked attention below, both the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import few_torch_threads  # noqa: F401 (autouse)
from unseenobjectswithmeanshift_tpu.ops.hypersphere_attention import (
    MhaParams, chunked_masked_meanshift_attention_twopass as jax_twopass,
)
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftAttention
from unseenobjectswithmeanshift_torch.ops.hypersphere_attention import (
    chunked_masked_meanshift_attention_twopass,
)

B, Q, K, E, NH, CHUNK = 2, 5, 200, 16, 2, 64


def _case(rng):
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    w = {n: f(E, E) * 0.4 for n in ("q", "k", "v", "o")}
    b = {n: f(E) * 0.1 for n in ("q", "k", "v", "o")}
    logits = f(B, Q, K)
    logits[0, 1] = -1.0 - np.abs(logits[0, 1])            # guard rows: every key masked
    logits[1, 4] = -1.0 - np.abs(logits[1, 4])
    return f(B, Q, E), f(B, K, E), f(B, K, E), w, b, logits, f(B, Q, E)


def test_twopass_matches_jax(rng):
    q, k, v, w, b, logits, cot = _case(rng)

    def jax_loss(q, k, v, w, b):
        p = MhaParams(w["q"], w["k"], w["v"], b["q"], b["k"], b["v"], w["o"], b["o"])
        out = jax_twopass(p, q, k, v, NH, jnp.asarray(logits), chunk_size=CHUNK)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                                   has_aux=True))(q, k, v, w, b)
    tt = lambda a: torch.tensor(a, requires_grad=True)   # noqa: E731
    tq, tk, tv = tt(q), tt(k), tt(v)
    tw = {n: tt(x) for n, x in w.items()}
    tb = {n: tt(x) for n, x in b.items()}
    in_w = torch.cat([tw[n].T for n in "qkv"])            # flax [in, out] -> torch [out, in]
    in_b = torch.cat([tb[n] for n in "qkv"])
    out = chunked_masked_meanshift_attention_twopass(
        tq, tk, tv, in_w, in_b, tw["o"].T, tb["o"], NH, torch.tensor(logits) >= 0,
        chunk_size=CHUNK)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    (out * torch.tensor(cot)).sum().backward()
    got = [tq.grad, tk.grad, tv.grad] + [tw[n].grad for n in "qkvo"] + [tb[n].grad for n in "qkvo"]
    want = list(jgrads[:3]) + [jgrads[3][n] for n in "qkvo"] + [jgrads[4][n] for n in "qkvo"]
    for g, j in zip(got, want):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-4 * max(1.0, np.abs(j).max()))


def test_decoder_switches_to_chunked_form(rng, monkeypatch):
    import unseenobjectswithmeanshift_torch.models.decoder as dec

    q, k, v, w, b, logits, _ = _case(rng)
    attn = MeanShiftAttention(E, NH)
    with torch.no_grad():
        attn.in_proj_weight.copy_(torch.tensor(np.concatenate([w[n].T for n in "qkv"])))
        attn.in_proj_bias.copy_(torch.tensor(np.concatenate([b[n] for n in "qkv"])))
        attn.out_proj.weight.copy_(torch.tensor(w["o"].T))
        attn.out_proj.bias.copy_(torch.tensor(b["o"]))
    keep = torch.tensor(logits) >= 0
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), keep)
    with torch.no_grad():
        dense = attn.masked(*args)
        monkeypatch.setattr(dec, "CHUNKED_ATTENTION_MIN_K", K)
        chunked = attn.masked(*args)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)
