"""The port's mixture-of-experts layer and moe family (qwen2-moe-a2.7b,
arctic-480b) against the JAX package's (``repro.models.moe``).

Weights come from the JAX ``api.init`` / ``moe_init`` through
``convert``; inputs are numpy draws from fixed seeds.  Tolerances: the
loss, its aux term and every gradient rtol 1e-4 atol 1e-5, the layer's
output the same (fp32 smoke configs: matmuls and reductions that may sum
in another order); against the dense oracle and with padded experts the
JAX tests' bars (``tests/test_models.py:68,88``: 1e-5 and 1e-6); the
dispatch (which token each expert slot holds, and so which tokens are
dropped past capacity) equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_support import (ATOL, RTOL, assert_grads_match,  # noqa: E402
                               run_train_launcher)
from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import moe  # noqa: E402

MOE = ("qwen2-moe-a2.7b", "arctic-480b")


def _layer(arch="qwen2-moe-a2.7b", **changes):
    """One MoE layer in both packages on the JAX draw: (jcfg, jparams,
    cfg, module)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **changes)
    cfg = dataclasses.replace(configs.smoke_config(arch), **changes)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    m = moe.MoE(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        for name, p in m.named_parameters():
            node = jp
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.as_tensor(np.array(node)))
    return jcfg, jp, cfg, m


def _x(cfg, seed, b, s, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
            * scale).astype(np.float32)


@pytest.mark.parametrize("arch", MOE)
def test_grads_match_jax(arch):
    """One step's loss (CE + 0.01 aux), the aux loss and every gradient,
    the router's through the combine weights and the aux term."""
    metrics = assert_grads_match(arch)
    assert metrics["aux"] > 0.0


@pytest.mark.parametrize("arch", MOE)
def test_layer_matches_jax(arch):
    """moe_ffn alone: output and aux loss; arctic's dense residual and
    qwen2-moe's gated shared experts included."""
    jcfg, jp, cfg, m = _layer(arch)
    x = _x(cfg, 1, 2, 16, 0.5)
    want, jaux = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe.moe_ffn(m, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    assert (m.dense is not None) == cfg.dense_residual
    assert (m.shared is not None) == bool(cfg.n_shared_experts)


def test_dispatch_matches_dense_oracle():
    """With capacity to spare every token reaches its top-k experts: the
    layer equals the dense oracle of tests/test_models.py:68."""
    _, _, cfg, m = _layer(capacity_factor=100.0, n_shared_experts=0)
    x = torch.as_tensor(_x(cfg, 1, 2, 16, 0.5))
    with torch.no_grad():
        out, aux = moe.moe_ffn(m, cfg, x)
        t, d, e, k = 32, cfg.d_model, cfg.n_experts, cfg.n_experts_per_token
        xt = x.reshape(t, d)
        probs = torch.softmax(xt @ m.router, -1)
        top_w, top_e = torch.topk(probs, k)
        top_w = top_w / top_w.sum(-1, keepdim=True)
        h = torch.einsum("td,edf->tef", xt, m.w_up)
        g = torch.einsum("td,edf->tef", xt, m.w_gate)
        y_all = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * h,
                             m.w_down)
        w_full = torch.zeros((t, e)).scatter(1, top_e, top_w)
        expect = torch.einsum("te,ted->td", w_full, y_all).reshape(2, 16, d)
    assert float((out - expect).abs().max()) < 1e-5
    assert float(aux) > 0.0


def test_padded_experts_unused():
    """Padded experts receive no tokens and contribute nothing
    (tests/test_models.py:88); the padded layer matches the JAX one."""
    jcfg, jp, cfg, m = _layer(n_experts_pad=12, n_shared_experts=0)
    assert m.w_up.shape[0] == 12 and m.router.shape[1] == cfg.n_experts
    x = _x(cfg, 1, 2, 16)
    with torch.no_grad():
        out, _ = moe.moe_ffn(m, cfg, torch.as_tensor(x))
        for nm in ("w_up", "w_gate", "w_down"):
            getattr(m, nm)[cfg.n_experts:] = 0.0
        out2, _ = moe.moe_ffn(m, cfg, torch.as_tensor(x))
    assert float((out - out2).abs().max()) < 1e-6
    want, _ = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seq", [1, 64, 256])
def test_drops_match_jax_under_half_capacity(seq):
    """capacity_factor 0.5: experts overflow, and the tokens each slot
    holds -- hence the dropped ones -- equal the JAX dispatch's.  Which
    tokens overflow depends on the order within an expert's run of the
    sorted assignments, so this holds only with a stable sort."""
    jcfg, jp, cfg, m = _layer(capacity_factor=0.5, n_shared_experts=0)
    b, k = 3, cfg.n_experts_per_token
    x = _x(cfg, 7, b, seq)
    cap = moe._capacity(cfg, seq)
    assert cap == jmoe._capacity(jcfg, seq)
    # the router's choice, from the JAX package, fed to both dispatches
    logits = jnp.asarray(x) @ jp["router"]
    top_w, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    _, want, _ = jax.vmap(lambda xr, er, wr: jmoe._dispatch_row(
        jcfg, xr, er, wr, cap))(jnp.asarray(x), top_e, top_w)
    slot_tok, slot_of = moe._dispatch(cfg, torch.as_tensor(np.array(top_e)),
                                      cap)
    np.testing.assert_array_equal(slot_tok.numpy(), np.asarray(want))
    held = slot_of < cfg.e_eff * cap
    if seq == 256:
        assert int((~held).sum()) > 0, "no expert overflowed"
    # each kept assignment's slot holds its token; the held count per row
    assert (slot_tok >= 0).sum(-1).tolist() == held.reshape(b, -1) \
        .sum(-1).tolist()
    rows = torch.arange(b)[:, None, None].expand_as(slot_of)
    toks = torch.arange(seq)[None, :, None].expand_as(slot_of)
    assert torch.equal(slot_tok[rows[held], slot_of[held]], toks[held])
    want_out, _ = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, _ = moe.moe_ffn(m, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=RTOL,
                               atol=ATOL)


def test_expert_stacks_are_drawn_a_slice_at_a_time():
    """The stacks hold one draw per expert, scaled by 1/sqrt(fan_in), in
    the parameter dtype (arctic's bf16)."""
    cfg = dataclasses.replace(configs.smoke_config("arctic-480b"),
                              param_dtype="bfloat16", moe_d_ff=256)
    m = moe.MoE(torch.Generator().manual_seed(4), cfg)
    assert m.w_up.dtype == torch.bfloat16
    assert m.w_up.shape == (cfg.e_eff, cfg.d_model, cfg.moe_d_ff)
    std = m.w_down.detach().float().std(dim=(1, 2))
    np.testing.assert_allclose(std.numpy(), cfg.moe_d_ff ** -0.5, rtol=0.05)
    assert not torch.equal(m.w_up[0], m.w_up[1])


def test_active_params_feed_the_model_flops():
    """qwen2-moe's MODEL_FLOPS count its routed top-4 experts, not all
    60: 2.689e9 active of 14.316e9."""
    cfg = configs.get_config("qwen2-moe-a2.7b")
    assert abs(cfg.active_param_count() / 2.689e9 - 1) < 1e-3
    assert abs(cfg.param_count() / 14.316e9 - 1) < 1e-3
    assert roofline.model_flops("train", cfg.active_param_count(), 4, 2048) \
        == 6.0 * cfg.active_param_count() * 4 * 2048


@pytest.mark.parametrize("arch", MOE)
def test_train_launcher_runs_the_family_on_cpu(arch, tmp_path):
    run_train_launcher(arch, tmp_path)
