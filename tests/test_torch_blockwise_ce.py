"""The PyTorch port's blockwise LM-head cross entropy held against the JAX
package on the CPU: the plain versions (loss, lse, dh, dw) against the
Pallas kernels ``_ce_fwd`` / ``_ce_bwd_dh`` / ``_ce_bwd_dw`` in interpret
mode, the port's autograd op against ``jax.grad`` of
``blockwise_lm_head_ce``, and the model's ``fused_lm_head_loss`` in its
blockwise and scan modes against the JAX package's pallas and scan modes.

Tolerances: float32 atol 2e-5 (both sides sum the same f32 products of
an H-deep dot in another order; values are O(1) to O(10)). bfloat16
inputs: the logits are the same exact products summed in f32, so loss
and lse stay within 2e-5; dh and dw round once to bf16 from f32 sums
that may differ in the last f32 bits, so they may land one bf16 unit in
the last place apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.ops.pallas.blockwise_ce as BC  # noqa: E402
from paddle_tpu.models.llama import fused_lm_head_loss as jfused  # noqa: E402
from paddle_tpu_torch.models.llama import fused_lm_head_loss  # noqa: E402
from paddle_tpu_torch.ops import blockwise_ce as tbc  # noqa: E402

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = BC._INTERPRET
    BC._INTERPRET = True
    yield
    BC._INTERPRET = old


def _inputs(seed, t, hid, vocab, ignored=(3,)):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, hid)).astype(np.float32)
    w = (rng.normal(size=(hid, vocab)) * 0.1).astype(np.float32)
    lab = rng.integers(0, vocab, t).astype(np.int32)
    lab[list(ignored)] = -100
    g = rng.uniform(0.5, 1.5, t).astype(np.float32)
    return h, w, lab, g


def _jax_all(h, w, lab, g, bt, bv, bbv, ignore=-100):
    jh, jw, jl, jg = (jnp.asarray(x) for x in (h, w, lab, g))
    loss, lse = BC._ce_fwd(jh, jw, jl, ignore, bt, bv)
    dh = BC._ce_bwd_dh(jh, jw, jl, jg, lse, ignore, bt, bbv)
    dw = BC._ce_bwd_dw(jh, jw, jl, jg, lse, ignore, bt, bbv)
    return [np.asarray(x) for x in (loss, lse, dh, dw)]


def _port_all(h, w, lab, g, ignore=-100, dtype=torch.float32):
    th, tw = (torch.as_tensor(x).to(dtype) for x in (h, w))
    tl = torch.as_tensor(lab).long()
    tg = torch.as_tensor(g)
    loss, lse = tbc.ce_fwd(th, tw, tl, ignore)
    dh = tbc.ce_bwd_dh(th, tw, tl, tg, lse, ignore)
    dw = tbc.ce_bwd_dw(th, tw, tl, tg, lse, ignore)
    return [loss, lse, dh, dw]


SHAPES = [
    (96, 64, 300, 32, 128, 128),    # ragged T and V
    (128, 64, 256, 32, 128, 128),   # exact tiling
    (64, 128, 384, 64, 128, 256),   # backward blocks differ from forward
]


@pytest.mark.parametrize("T,H,V,bt,bv,bbv", SHAPES)
def test_plain_versions_match_the_pallas_kernels(T, H, V, bt, bv, bbv):
    h, w, lab, g = _inputs(0, T, H, V)
    want = _jax_all(h, w, lab, g, bt, bv, bbv)
    got = [x.numpy() for x in _port_all(h, w, lab, g)]
    for name, wv, gv in zip(("loss", "lse", "dh", "dw"), want, got):
        assert gv.dtype == np.float32 and gv.shape == wv.shape, name
        np.testing.assert_allclose(gv, wv, rtol=0, atol=ATOL, err_msg=name)
    assert got[0][3] == 0.0 and not got[2][3].any()   # the ignored row


@pytest.mark.parametrize("T,H,V,bt,bv,bbv", SHAPES)
def test_autograd_op_matches_jax_grad(T, H, V, bt, bv, bbv):
    h, w, lab, g = _inputs(1, T, H, V, ignored=(0, 5))

    def f(h_, w_):
        return jnp.sum(BC.blockwise_lm_head_ce(h_, w_, jnp.asarray(lab), -100,
                                               bt, bv, bbv) * jnp.asarray(g))

    jl, (jdh, jdw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(h),
                                                          jnp.asarray(w))
    th, tw = (torch.tensor(x, requires_grad=True) for x in (h, w))
    loss = tbc.blockwise_lm_head_ce(th, tw, torch.as_tensor(lab))
    total = (loss * torch.as_tensor(g)).sum()
    total.backward()
    assert abs(float(total.detach()) - float(jl)) <= ATOL * max(1.0,
                                                                abs(float(jl)))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=ATOL)


def test_fully_ignored_batch_gives_zero_loss_and_gradients():
    rng = np.random.default_rng(1)
    h = torch.tensor(rng.normal(size=(32, 64)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(64, 128)).astype(np.float32),
                     requires_grad=True)
    lab = torch.full((32,), -100)
    loss = tbc.blockwise_lm_head_ce(h, w, lab)
    assert float(loss.detach().abs().max()) == 0.0
    loss.sum().backward()
    assert float(h.grad.abs().max()) == 0.0
    assert float(w.grad.abs().max()) == 0.0
    # the model's mean: the denominator is clamped to one
    hs = h.detach().reshape(2, 16, 64).requires_grad_(True)
    mean = fused_lm_head_loss(hs, w, lab.reshape(2, 16))
    assert float(mean.detach()) == 0.0


def test_labels_outside_the_vocabulary_have_no_gold_logit():
    """A label outside [0, V) that is not ignore_index contributes its
    lse as the loss and no onehot to the gradient, in both packages."""
    h, w, lab, g = _inputs(2, 32, 64, 200)
    lab[[1, 2]] = [537, 1000]
    lab[4] = -7
    want = _jax_all(h, w, lab, g, 32, 128, 128)
    got = [x.numpy() for x in _port_all(h, w, lab, g)]
    for name, wv, gv in zip(("loss", "lse", "dh", "dw"), want, got):
        np.testing.assert_allclose(gv, wv, rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got[0][[1, 2, 4]], got[1][[1, 2, 4]])


def test_reference_label_in_the_padded_tile_gets_a_masked_gold_logit():
    """A fault of the reference, not of the port: a label in [V, the
    vocab padded to the tile) matches a padded column whose logit the
    forward kernel masked to -1e30 (blockwise_ce.py:76-95), so its loss
    is 1e30. The port reads no gold logit there (loss = lse); the
    gradients agree, since the padded column is cut from dw and meets
    zeroed w columns in dh."""
    h, w, lab, g = _inputs(2, 32, 64, 200)
    lab[1] = 200
    want = _jax_all(h, w, lab, g, 32, 128, 128)
    got = [x.numpy() for x in _port_all(h, w, lab, g)]
    assert want[0][1] > 1e29
    assert got[0][1] == got[1][1]
    keep = np.arange(32) != 1
    np.testing.assert_allclose(got[0][keep], want[0][keep], rtol=0,
                               atol=ATOL)
    for name, wv, gv in zip(("lse", "dh", "dw"), want[1:], got[1:]):
        np.testing.assert_allclose(gv, wv, rtol=0, atol=ATOL, err_msg=name)


def test_bf16_inputs_take_the_dtype_steps():
    h, w, lab, g = _inputs(3, 96, 64, 300)
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16))
    wb = np.asarray(jnp.asarray(w, jnp.bfloat16))
    jh, jw = jnp.asarray(hb), jnp.asarray(wb)
    want = _jax_all(jh, jw, lab, g, 32, 128, 128)
    got = _port_all(hb.astype(np.float32), wb.astype(np.float32), lab, g,
                    dtype=torch.bfloat16)
    assert got[2].dtype == got[3].dtype == torch.bfloat16
    assert got[0].dtype == got[1].dtype == torch.float32
    for name, wv, gv in zip(("loss", "lse"), want, got):
        np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=ATOL,
                                   err_msg=name)
    for name, wv, gv in zip(("dh", "dw"), want[2:], got[2:]):
        wf = np.asarray(wv, np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(wf), 2.0 ** -100)))
                      - 7)
        assert (np.abs(gv.float().numpy() - wf) <= ulp + 1e-7).all(), name


@pytest.mark.parametrize("mode", ["pallas", "scan"])
def test_fused_lm_head_loss_matches_the_jax_modes(mode):
    """The model's entry point: loss and its gradients on the hidden
    states and the head weight, the port's blockwise (mode None) and scan
    modes against the JAX package's pallas (interpret) and scan modes."""
    rng = np.random.default_rng(2)
    b, s, hid, vocab = 2, 24, 32, 96
    hs = rng.normal(size=(b, s, hid)).astype(np.float32)
    w = (rng.normal(size=(hid, vocab)) * 0.1).astype(np.float32)
    lab = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab[0, :3] = -100
    jh = paddle.to_tensor(hs, stop_gradient=False)
    jw = paddle.to_tensor(w, stop_gradient=False)
    jl = jfused(jh, jw, paddle.to_tensor(lab), mode=mode, chunk_tokens=20)
    jl.backward()
    th, tw = (torch.tensor(x, requires_grad=True) for x in (hs, w))
    tl = fused_lm_head_loss(th, tw, torch.as_tensor(lab), chunk_tokens=20,
                            mode=None if mode == "pallas" else mode)
    tl.backward()
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert abs(float(tl.detach()) - float(jl.numpy())) <= ATOL
    np.testing.assert_allclose(th.grad.numpy(), jh.grad.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="mode"):
        fused_lm_head_loss(th, tw, torch.as_tensor(lab), mode="xla")


def test_a_transposed_head_takes_the_contiguous_copy():
    """A tied head hands the [H, V] view of a [V, H] table: the op copies
    it contiguous and dw reaches the table transposed."""
    h, w, lab, g = _inputs(4, 40, 32, 70)
    table = torch.tensor(np.ascontiguousarray(w.T), requires_grad=True)
    th = torch.tensor(h, requires_grad=True)
    loss = tbc.blockwise_lm_head_ce(th, table.t(), torch.as_tensor(lab))
    (loss * torch.as_tensor(g)).sum().backward()
    ref = _port_all(h, w, lab, g)
    np.testing.assert_allclose(loss.detach().numpy(), ref[0].numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(table.grad.numpy(), ref[3].numpy().T, rtol=0,
                               atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    h = torch.zeros(8, 16)
    w = torch.zeros(16, 32)
    lab = torch.zeros(8, dtype=torch.int64)
    tbc._check("ce_fwd", h, w, lab)
    for bad in ((h, w.bfloat16(), lab), (h.double(), w.double(), lab),
                (h, w, lab.int()), (h, torch.zeros(15, 32), lab),
                (h, w, lab[:7]), (h.t().contiguous().t(), w, lab),
                (h, w.t().contiguous().t(), lab)):
        with pytest.raises(ValueError):
            tbc._check("ce_fwd", *bad)
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="float32"):
        tbc._check("ce_bwd_dh", h, w, lab, g.double(), g)
    with pytest.raises(ValueError, match="unsupported device"):
        tbc.ce_fwd(h.to("meta"), w.to("meta"), lab.to("meta"), -100)
    for fn in (tbc.ce_bwd_dh, tbc.ce_bwd_dw):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(h.to("meta"), w.to("meta"), lab.to("meta"), g.to("meta"),
               g.to("meta"), -100)


def test_cpu_backward_takes_the_plain_version_and_leaves_the_route():
    """On CPU tensors the backward wrappers run the plain versions: no
    kernel route is chosen and no launch is counted."""
    h, w, lab, g = (torch.as_tensor(x) for x in _inputs(5, 20, 16, 40))
    lab = lab.long()
    _, lse = tbc.ce_fwd_plain(h, w, lab, -100)
    before = (tbc.ce_bwd_dh.launches, tbc.ce_bwd_dw.launches,
              tbc.ce_bwd_dh.route, tbc.ce_bwd_dw.route)
    dh = tbc.ce_bwd_dh(h, w, lab, g, lse, -100)
    dw = tbc.ce_bwd_dw(h, w, lab, g, lse, -100)
    np.testing.assert_array_equal(
        dh.numpy(), tbc.ce_bwd_dh_plain(h, w, lab, g, lse, -100).numpy())
    np.testing.assert_array_equal(
        dw.numpy(), tbc.ce_bwd_dw_plain(h, w, lab, g, lse, -100).numpy())
    assert (tbc.ce_bwd_dh.launches, tbc.ce_bwd_dw.launches,
            tbc.ce_bwd_dh.route, tbc.ce_bwd_dw.route) == before


@pytest.mark.parametrize("tool", ["ce_kernel_ab.py", "ce_kernel_phases.py"])
def test_ce_kernel_tools_refuse_without_a_card(tool):
    """The CE kernels' A/B and phase tools measure only on a card: without
    one they exit 2 and print no result."""
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(root, "tools", tool)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "CUDA is not available" in r.stderr and r.stdout == ""


def test_ce_kernel_phases_tool_finds_its_anchors_in_the_kernel():
    """The phase tool instruments the cluster kernel at anchor lines of its
    text: every phase marker lands once in the current source."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "ce_kernel_phases", os.path.join(root, "tools",
                                         "ce_kernel_phases.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(root, "paddle_tpu_torch", "csrc",
                           "blockwise_ce.cu")) as f:
        out = tool.instrument(f.read())
    for k in range(len(tool.PHASES)):
        assert out.count(f"PHASE_MARK({k})") == 1, k
    assert "int phase_read(" in out and "int phase_reset(" in out
