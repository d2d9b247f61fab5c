"""The port's mixture of experts (``paddle_tpu_torch.incubate.distributed.
models.moe`` and ``incubate.nn.functional.fused_moe``) held against the
JAX package on the 8 virtual CPU devices of ``tests/conftest.py``.

Both take the same numpy inputs, made from a seed; the port's layers load
the JAX layers' weights (``moe_state_from_numpy``). Routing is compared
exactly: dispatch masks, slots and top-k routes equal; combine weights
and the aux loss within 1e-6. Layer outputs, ``l_aux`` and every
gradient at rtol 1e-5 in f32, with an absolute floor of 2e-6 times the
tensor's largest element (at least 1) for elements that are sums of
cancelling terms (the gate's gradient; readings up to 1.3e-6): the port
sums each token's k rows where the JAX layer contracts the dense combine
tensor, in another order. Under expert parallelism the
port's ranks are gloo threads (``testing.ThreadRankSet``), each with its
own tokens; the JAX side is its expert-parallel layer over a P-device
mesh run on one rank's tokens at a time. ``fused_moe`` in bf16: within
2e-2 of the output's largest element (the JAX function rounds every
expert's products over all tokens to bf16, the port only its tokens'
rows; readings below 8e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.incubate.nn.functional as JF  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.distributed import ProcessMesh as JMesh  # noqa: E402
from paddle_tpu.incubate.distributed.models import moe as jmoe  # noqa: E402
import paddle_tpu_torch.incubate.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.incubate.distributed.models import moe  # noqa: E402
from paddle_tpu_torch.models import pretrain as tpre  # noqa: E402
from paddle_tpu_torch.testing import ThreadRankSet  # noqa: E402

RTOL = 1e-5
D, F = 16, 32


def close(got, ref, rtol=RTOL, atol=2e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale)


def _probs(rng, t, e, kind):
    if kind == "ties":      # equal probabilities within and across tokens
        p = rng.integers(0, 3, (t, e)).astype(np.float32) + 1.0
    elif kind == "skewed":  # every token prefers expert 0: overflow
        p = rng.random((t, e)).astype(np.float32)
        p[:, 0] += 4.0
    else:
        p = rng.random((t, e)).astype(np.float32)
    return p / p.sum(axis=1, keepdims=True)


# (T, E, k, C, kind): overflow of one expert, ties, tokens with every
# choice dropped (k = 1 at C = 2), k past the distinct choices (E = 2)
GRID = [(16, 4, 2, 8, "random"), (64, 8, 2, 16, "random"),
        (32, 4, 1, 4, "skewed"), (32, 4, 2, 2, "skewed"),
        (24, 4, 2, 5, "ties"), (40, 8, 3, 6, "ties"),
        (12, 2, 2, 12, "random"), (9, 3, 1, 1, "random")]


@pytest.mark.parametrize("t,e,k,c,kind", GRID)
def test_topk_capacity_dispatch_equals_jax(t, e, k, c, kind):
    probs = _probs(np.random.default_rng(t * 31 + e), t, e, kind)
    jc, jd, ja = jmoe.topk_capacity_dispatch(paddle.to_tensor(probs).data,
                                             k, c)
    tc, td, ta = moe.topk_capacity_dispatch(torch.tensor(probs), k, c)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    if kind == "skewed" and k == 1:   # dropped tokens: zero combine rows
        dropped = np.asarray(jd).sum(axis=(1, 2)) == 0
        assert dropped.any()
        assert not tc.numpy()[dropped].any()


def test_index_form_slots_and_weights():
    probs = _probs(np.random.default_rng(3), 32, 4, "skewed")
    expert, slot, weight, _ = moe.topk_capacity_route(
        torch.tensor(probs), 2, 6)
    comb, disp, _ = moe.topk_capacity_dispatch(torch.tensor(probs), 2, 6)
    live = slot >= 0
    # each slot holds one (token, choice); dispatched iff weight > 0
    flat = (expert * 6 + slot)[live]
    assert flat.unique().numel() == flat.numel()
    assert torch.equal(live, weight > 0)
    assert int(disp.sum()) == int(live.sum())
    rows = torch.arange(32)[:, None].expand_as(slot)[live]
    assert torch.equal(comb.reshape(32, -1)[rows, flat], weight[live])


def _gate_pair(kind, e=4, top_k=2):
    if kind == "naive":
        return (jmoe.NaiveGate(D, e, top_k=top_k),
                moe.NaiveGate(D, e, top_k=top_k, device="cpu"))
    if kind == "switch":
        return (jmoe.SwitchGate(D, e),
                moe.SwitchGate(D, e, device="cpu").eval())
    return (jmoe.GShardGate(D, e, top_k=top_k),
            moe.GShardGate(D, e, top_k=top_k, device="cpu"))


@pytest.mark.parametrize("kind", ["naive", "switch", "gshard"])
def test_gates_equal_jax(kind, rng):
    jg, tg = _gate_pair(kind)
    x = rng.standard_normal((24, D)).astype(np.float32)
    w = jg.weight.numpy()
    jc, jd, ja = jg.routing(paddle.to_tensor(x).data, jg.weight.data)
    with torch.no_grad():
        tg.weight.copy_(torch.tensor(w))
    with torch.no_grad():
        tc, td, ta = tg.routing(torch.tensor(x))
    assert (tg.num_experts, tg.top_k, tg.capacity_factor) == \
        (jg.num_experts, jg.top_k, jg.capacity_factor)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)


def test_switch_gate_jitter_draws_from_its_generator(rng):
    g = moe.SwitchGate(D, 4, switch_eps=0.5, device="cpu",
                       jitter_generator=torch.Generator().manual_seed(5))
    x = torch.tensor(rng.standard_normal((16, D)).astype(np.float32))
    g.train()
    a = g.probs(x)
    g.jitter_generator.manual_seed(5)
    assert torch.equal(a, g.probs(x))
    assert not torch.equal(a, g.eval().probs(x))


def _randomize(layer, rng):
    for _, p in layer.named_parameters():
        p.set_value((rng.standard_normal(p.shape) * 0.3).astype(np.float32))


def _state(layer):
    return {n: p.numpy() for n, p in layer.named_parameters()}


def _jax_run(layer, x, dy, c_aux=0.7):
    xt = paddle.to_tensor(x, stop_gradient=False)
    y = layer(xt)
    ((y * paddle.to_tensor(dy)).sum() + layer.l_aux * c_aux).backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    layer.clear_gradients()
    return y.numpy(), float(layer.l_aux.numpy()), xt.grad.numpy(), grads


def _torch_run(layer, x, dy, c_aux=0.7):
    xt = torch.tensor(x, requires_grad=True)
    y = layer(xt)
    ((y * torch.tensor(dy)).sum() + layer.l_aux * c_aux).backward()
    return y, layer.l_aux, xt.grad


def _jax_layer(form, act="gelu", e=4):
    if form == "batched":
        return jmoe.MoELayer(d_model=D, experts=jmoe.ExpertMLP(
            e, D, F, activation=act), gate=jmoe.NaiveGate(D, e, top_k=2))
    if form == "layerlist":
        return jmoe.MoELayer(d_model=D, experts=jnn.LayerList(
            [jnn.Linear(D, D) for _ in range(e)]),
            gate=jmoe.NaiveGate(D, e, top_k=2))
    return jmoe.MoELayer(d_model=D, experts=jmoe.ExpertMLP(e, D, F),
                         gate={"type": form, "top_k": 2})


def _torch_layer(form, act="gelu", e=4, **kw):
    if form == "batched":
        return moe.MoELayer(d_model=D, experts=moe.ExpertMLP(
            e, D, F, activation=act, device="cpu"),
            gate=moe.NaiveGate(D, e, top_k=2, device="cpu"), **kw)
    if form == "layerlist":
        return moe.MoELayer(d_model=D, experts=torch.nn.ModuleList(
            [torch.nn.Linear(D, D) for _ in range(e)]),
            gate=moe.NaiveGate(D, e, top_k=2, device="cpu"), **kw)
    return moe.MoELayer(d_model=D, experts=moe.ExpertMLP(
        e, D, F, device="cpu"), gate={"type": form, "top_k": 2}, **kw)


def _expert_grads(layer):
    if isinstance(layer.experts, moe.ExpertMLP):
        return {f"experts.{n}": getattr(layer.experts, n).grad
                for n in ("w1", "b1", "w2", "b2")}
    out = {}
    for j, m in enumerate(layer.experts):
        out[f"experts.{j}.weight"] = m.weight.grad.T
        out[f"experts.{j}.bias"] = m.bias.grad
    return out


@pytest.mark.parametrize("form,act", [
    ("batched", "gelu"), ("batched", "relu"), ("batched", "silu"),
    ("layerlist", None), ("gshard", None), ("switch", None)])
def test_moe_layer_equals_jax(form, act, rng):
    jl = _jax_layer(form, act or "gelu")
    _randomize(jl, rng)
    tl = _torch_layer(form, act or "gelu")
    moe.moe_state_from_numpy(tl, _state(jl))
    if form == "switch":
        jl.eval()
        tl.eval()
    x = rng.standard_normal((4, 8, D)).astype(np.float32)
    dy = rng.standard_normal((4, 8, D)).astype(np.float32)
    jy, jaux, jdx, jgrads = _jax_run(jl, x, dy)
    y, aux, dx = _torch_run(tl, x, dy)
    close(y, jy)
    np.testing.assert_allclose(float(aux.detach()), jaux, rtol=RTOL)
    close(dx, jdx)
    close(tl.gate.weight.grad, jgrads["gate.weight"])
    for name, g in _expert_grads(tl).items():
        close(g, jgrads[name])


def test_moe_layer_drops_overflow_to_zero(rng):
    """A token whose choice was dropped gets y = 0 there, not b2."""
    jl = jmoe.MoELayer(d_model=D, experts=jmoe.ExpertMLP(2, D, F),
                       gate=jmoe.NaiveGate(D, 2, top_k=1,
                                           capacity_factor=0.25))
    _randomize(jl, rng)
    tl = moe.MoELayer(d_model=D, experts=moe.ExpertMLP(2, D, F,
                                                       device="cpu"),
                      gate=moe.NaiveGate(D, 2, top_k=1, capacity_factor=0.25,
                                         device="cpu"))
    moe.moe_state_from_numpy(tl, _state(jl))
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    jy = jl(paddle.to_tensor(x)).numpy()
    y = tl(torch.tensor(x)).detach().numpy()
    zero = ~jy.reshape(16, D).any(axis=1)
    assert zero.sum() >= 8
    assert not y.reshape(16, D)[zero].any()
    close(y, jy)


def test_moe_layer_refusals():
    with pytest.raises(ValueError, match="experts required"):
        moe.MoELayer(d_model=D)
    with pytest.raises(ValueError, match="d_model is required"):
        moe.MoELayer(experts=torch.nn.ModuleList([torch.nn.Linear(D, D)]))
    with pytest.raises(ValueError, match="activation"):
        moe.ExpertMLP(2, D, F, activation="tanh", device="cpu")


def _ep_case(p, seed, form="batched", e=8, via_mesh=False):
    rng = np.random.default_rng(seed)
    jl = _jax_layer(form, e=e)
    _randomize(jl, rng)
    state = _state(jl)
    xs = [rng.standard_normal((2, 8, D)).astype(np.float32)
          for _ in range(p)]
    dys = [rng.standard_normal((2, 8, D)).astype(np.float32)
           for _ in range(p)]
    # the JAX layer's expert-parallel form (GSPMD over a p-device mesh),
    # each rank's tokens alone
    jep = jmoe.MoELayer(d_model=D, experts=jl.experts, gate=jl.gate,
                        mesh=JMesh(np.arange(p), dim_names=["expert"]),
                        axis_name="expert")
    refs = [_jax_run(jep, xs[r], dys[r]) for r in range(p)]

    def rank(r, group):
        torch.manual_seed(r)
        stats = {}
        if via_mesh:
            mesh = tpre.make_mesh(p, dp=p, group=group, device="cpu")
            tl = _torch_layer(form, e=e, mesh=mesh, axis_name="dp",
                              stats=stats)
        else:
            tl = _torch_layer(form, e=e, moe_group=group, stats=stats)
        moe.moe_state_from_numpy(tl, state)
        y, aux, dx = _torch_run(tl, xs[r], dys[r])
        cap = tl.gate.capacity(16)
        return dict(y=y.detach(), aux=float(aux.detach()), dx=dx,
                    gate=tl.gate.weight.grad, experts=_expert_grads(tl),
                    stats=stats, cap=cap, local=tl.num_local_experts)

    got = ThreadRankSet(p, rank, timeout=60).join(240)
    return refs, got


@pytest.mark.parametrize("p,form,via_mesh", [
    (2, "batched", False), (4, "batched", False), (2, "layerlist", False),
    (4, "batched", True)])
def test_expert_parallel_rank_equals_jax_on_its_tokens(p, form, via_mesh):
    e = 8
    refs, got = _ep_case(p, 7 + p, form, e, via_mesh)
    for r in range(p):
        jy, jaux, jdx, jgrads = refs[r]
        g = got[r]
        assert g["local"] == e // p
        close(g["y"], jy)
        np.testing.assert_allclose(g["aux"], jaux, rtol=RTOL)
        close(g["dx"], jdx)
        close(g["gate"], jgrads["gate.weight"])
        # expert weight gradients: the sum over ranks of each rank's
        # tokens' gradients, for this rank's experts
        lo = r * (e // p)
        for name, grad in g["experts"].items():
            if form == "batched":
                want = sum(refs[q][3][name] for q in range(p))[lo:lo + e // p]
            else:
                j = int(name.split(".")[1])
                key = name.replace(f".{j}.", f".{lo + j}.")
                want = sum(refs[q][3][key] for q in range(p))
            close(grad, want)
        # 2 forward + 2 backward exchanges of E * C * d f32 elements
        label = "all_to_all,dp" if via_mesh else "all_to_all,ep"
        assert g["stats"] == {label: {"calls": 4,
                                      "bytes": 4 * e * g["cap"] * D * 4}}


def test_expert_parallel_same_batch_every_rank_equals_jax(rng):
    p, e = 2, 4
    jl = _jax_layer("batched", e=e)
    _randomize(jl, rng)
    state = _state(jl)
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    dy = rng.standard_normal((2, 8, D)).astype(np.float32)
    jy, _, jdx, _ = _jax_run(jl, x, dy)

    def rank(r, group):
        tl = _torch_layer("batched", e=e, moe_group=group)
        moe.moe_state_from_numpy(tl, state)
        y, _, dx = _torch_run(tl, x, dy)
        return y.detach(), dx

    for y, dx in ThreadRankSet(p, rank, timeout=60).join(240).values():
        close(y, jy)
        close(dx, jdx)


def test_expert_parallel_refuses_uneven_split():
    def rank(r, group):
        with pytest.raises(ValueError, match="do not divide"):
            _torch_layer("batched", e=6, moe_group=group)
        return True

    assert all(ThreadRankSet(4, rank, timeout=30).join(120).values())


@pytest.mark.parametrize("p", [2, 4])
def test_global_scatter_gather_equal_jax_blocks(p, rng):
    e, c = 8, 3
    buf = rng.standard_normal((e, p * c, D)).astype(np.float32)
    inv = rng.standard_normal((e, p * c, D)).astype(np.float32)
    mesh = JMesh(np.arange(p), dim_names=["expert"])
    js = jmoe.global_scatter(paddle.to_tensor(buf), mesh=mesh,
                             axis_name="expert").numpy()
    jg = jmoe.global_gather(paddle.to_tensor(inv), mesh=mesh,
                            axis_name="expert").numpy()
    el = e // p

    def rank(r, group):
        x = torch.tensor(buf[:, r * c:(r + 1) * c], requires_grad=True)
        s = moe.global_scatter(x, group=group)
        back = moe.global_gather(s, group=group)
        g = moe.global_gather(torch.tensor(inv[r * el:(r + 1) * el]),
                              group=group)
        # the backward of the scatter is the gather of the upstream
        up = torch.tensor(inv[r * el:(r + 1) * el])
        (s * up).sum().backward()
        return s.detach(), back.detach(), g, x.grad

    got = ThreadRankSet(p, rank, timeout=60).join(240)
    for r in range(p):
        s, back, g, dx = got[r]
        assert np.array_equal(s.numpy(), js[r * el:(r + 1) * el])
        assert np.array_equal(back.numpy(), buf[:, r * c:(r + 1) * c])
        assert np.array_equal(g.numpy(), jg[:, r * c:(r + 1) * c])
        assert np.array_equal(dx.numpy(), jg[:, r * c:(r + 1) * c])


# -- fused_moe ---------------------------------------------------------------

def _fused_inputs(rng, glu, biases, e=4, b=2, s=5, d=8, f=6):
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    gw = rng.normal(size=(d, e)).astype(np.float32)
    w1 = (rng.normal(size=(e, d, 2 * f if glu else f)) * 0.3).astype(
        np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.3).astype(np.float32)
    b1 = rng.normal(size=(e, 1, w1.shape[-1])).astype(np.float32) \
        if biases else None
    b2 = rng.normal(size=(e, 1, d)).astype(np.float32) if biases else None
    return x, gw, w1, w2, b1, b2


def _jt(a, grad=False):
    return None if a is None else paddle.to_tensor(a, stop_gradient=not grad)


def _tt(a, grad=False):
    return None if a is None else torch.tensor(a, requires_grad=grad)


def _fused_both(x, gw, w1, w2, b1=None, b2=None, s1=None, s2=None,
                grads=True, **kw):
    dy = np.random.default_rng(99).normal(size=x.shape).astype(np.float32)
    jx, jgw, jw1 = _jt(x, grads), _jt(gw, grads), _jt(w1, grads and
                                                     w1.dtype != np.int8)
    jy = JF.fused_moe(jx, jgw, jw1, _jt(w2), _jt(b1), _jt(s1), _jt(b2),
                      _jt(s2), **kw)
    tx, tgw, tw1 = _tt(x, grads), _tt(gw, grads), _tt(w1, grads and
                                                      w1.dtype != np.int8)
    ty = TF.fused_moe(tx, tgw, tw1, _tt(w2), _tt(b1), _tt(s1), _tt(b2),
                      _tt(s2), **kw)
    close(ty, jy.numpy())
    if grads:
        (jy * paddle.to_tensor(dy)).sum().backward()
        (ty * torch.tensor(dy)).sum().backward()
        close(tx.grad, jx.grad.numpy())
        close(tgw.grad, jgw.grad.numpy())
        if w1.dtype != np.int8:
            close(tw1.grad, jw1.grad.numpy())
    return ty


@pytest.mark.parametrize("glu", [True, False])
@pytest.mark.parametrize("biases", [True, False])
@pytest.mark.parametrize("norm", [True, False])
def test_fused_moe_equals_jax(glu, biases, norm, rng):
    _fused_both(*_fused_inputs(rng, glu, biases), moe_topk=2,
                norm_topk_prob=norm)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fused_moe_3d_logits_with_ties(k, rng):
    x, _, w1, w2, b1, b2 = _fused_inputs(rng, True, True)
    # integer logits over 3 values: many equal probabilities a token
    logits = rng.integers(0, 3, (2, 5, 4)).astype(np.float32)
    _fused_both(x, logits, w1, w2, b1, b2, moe_topk=k)
    probs = torch.softmax(torch.tensor(logits).reshape(10, 4), -1)
    _, idx = TF._topk_stable(probs, k)
    import jax
    _, jidx = jax.lax.top_k(paddle.to_tensor(probs.numpy()).data, k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


def _int8(w, rng):
    sc = (np.abs(w).max(axis=1) / 127.0 + 1e-6).astype(np.float32)  # [E, N]
    q = np.clip(np.round(w / sc[:, None, :]), -127, 127).astype(np.int8)
    return q, sc


@pytest.mark.parametrize("glu", [True, False])
def test_fused_moe_int8_equals_jax(glu, rng):
    x, gw, w1, w2, b1, b2 = _fused_inputs(rng, glu, True)
    q1, s1 = _int8(w1, rng)
    q2, s2 = _int8(w2, rng)
    _fused_both(x, gw, q1, q2, b1, b2, s1, s2,
                quant_method="weight_only_int8", moe_topk=2)


def test_fused_moe_int8_without_scales_and_float_with_scales(rng):
    """JAX casts int8 weights without scales to x's dtype (K4 at unit
    scales in the port) and dequantizes float weights with scales."""
    x, gw, w1, w2, b1, b2 = _fused_inputs(rng, True, True)
    q1, s1 = _int8(w1, rng)
    q2, _ = _int8(w2, rng)
    _fused_both(x, gw, q1, (q2 // 16).astype(np.int8), b1, b2, moe_topk=2)
    _fused_both(x, gw, w1, w2, b1, b2, s1, None, moe_topk=2)


def test_fused_moe_skips_experts_without_tokens(rng):
    x, _, w1, w2, _, _ = _fused_inputs(rng, True, False, e=6)
    logits = rng.normal(size=(2, 5, 6)).astype(np.float32)
    logits[..., 3:] = -1e4               # experts 3-5 never chosen
    out = _fused_both(x, logits, w1, w2, moe_topk=2)
    assert TF.fused_moe.last_experts == 3
    assert out.shape == x.shape


def test_fused_moe_bf16_within_tolerance(rng):
    x, gw, w1, w2, b1, b2 = _fused_inputs(rng, True, True, d=16, f=24)
    bf = paddle.bfloat16 if hasattr(paddle, "bfloat16") else "bfloat16"
    jy = JF.fused_moe(*(paddle.to_tensor(a).astype(bf) for a in
                        (x, gw, w1, w2, b1)), None,
                      paddle.to_tensor(b2).astype(bf), moe_topk=2)
    ty = TF.fused_moe(*(torch.tensor(a).bfloat16() for a in
                        (x, gw, w1, w2, b1)), None,
                      torch.tensor(b2).bfloat16(), moe_topk=2)
    ref = np.asarray(jy.astype("float32").numpy())
    got = ty.float().numpy()
    assert ty.dtype == torch.bfloat16
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_fused_moe_refuses_unsupported_quant(rng):
    x, gw, w1, w2, _, _ = _fused_inputs(rng, True, False)
    args = [torch.tensor(a) for a in (x, gw, w1, w2)]
    with pytest.raises(NotImplementedError) as got:
        TF.fused_moe(*args, quant_method="weight_only_int4")
    with pytest.raises(NotImplementedError) as want:
        JF.fused_moe(*(paddle.to_tensor(a) for a in (x, gw, w1, w2)),
                     quant_method="weight_only_int4")
    assert str(got.value) == str(want.value)
