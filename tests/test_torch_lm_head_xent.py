"""The LM head and its cross-entropy through ``kernels.lm_head_xent``.

On the CPU: the op's plain version inside ``vocab_parallel_xent`` against
the formula it replaced (``_torch_lm_head_xent_worker.plain_xent``: f32
logits materialised and reduced by autograd) for the loss, the accuracy,
dX and dW, with vocab padding, a loss mask with zeros, labels on another
rank's shard, two gloo ranks of a model axis (TP, and SP's
``skip_gcopy``); the three-piece bf16 split; the meta path's stand-in
launches.

On the card (``cuda`` marker, skipped without one; this file imports no
JAX): the kernels against the plain version at small ragged shapes and at
slices of BERT-Large's and internlm2-1.8b's heads, and the precision
criterion: against a float64 computation, the kernels' per-row loss, loss,
dX (as x receives it) and dW errors are no more than twice those of the
f32 torch path they replace.

    python -m pytest -q tests/test_torch_lm_head_xent.py            # CPU
    python -m pytest -q -m cuda tests/test_torch_lm_head_xent.py    # card
"""
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_lm_head_xent_worker as worker
from repro_torch.kernels import build
from repro_torch.kernels.lm_head_xent import ops, ref
from repro_torch.models.transformer import vocab_parallel_xent
from repro_torch.perf import kernel_cost


# --------------------------------------------------------------------------
# the plain version against the formula it replaced (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vocab,mask_zeros", [(256, False), (250, True),
                                              (131, True)])
def test_xent_matches_plain_formula(dtype, vocab, mask_zeros):
    """Loss, accuracy, dX and dW of ``vocab_parallel_xent`` equal the
    materialised formula's on one rank: the padded columns past ``vocab``
    masked, rows with mask 0 carrying no loss and no gradient."""
    cfg = worker.config(vocab)
    x, w, labels, mask = worker.inputs(vocab, dtype, vocab=vocab,
                                       mask_zeros=mask_zeros)
    new = worker.loss_and_grads(vocab_parallel_xent, x, w, labels, mask, cfg)
    old = worker.loss_and_grads(worker.plain_xent, x, w, labels, mask, cfg)
    for a, b in zip(new, old):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    if mask_zeros:
        assert (new[2][mask.numpy() == 0] == 0).all()


def test_xent_reads_a_strided_prefix_slice():
    """The VLM stub's head input ``h[:, -L:]`` (a strided view) gives the
    loss and gradient of its contiguous copy."""
    cfg = worker.config()
    x, w, labels, mask = worker.inputs(3, torch.bfloat16, s=14)
    labels, mask = labels[:, -10:], mask[:, -10:]
    xs = x.detach().clone().requires_grad_()
    loss, _ = vocab_parallel_xent(xs[:, -10:], w, labels, mask, cfg)
    loss.backward()
    want = worker.loss_and_grads(worker.plain_xent, x[:, -10:], w, labels,
                                 mask, cfg)
    np.testing.assert_allclose(float(loss.detach()), want[0], rtol=1e-6)
    np.testing.assert_allclose(xs.grad[:, -10:].float().numpy(), want[2],
                               rtol=1e-6, atol=1e-7)
    assert (xs.grad[:, :-10] == 0).all()


@pytest.mark.parametrize("off", [0, 96, 200])
def test_op_statistics_on_a_shard(off):
    """The op's (m_l, s_l, ll_l) on the columns ``off .. off + 128`` of a
    250-token vocab: the row max and sum of exp of the masked logits, the
    label's logit where the label lies on the shard and 0 elsewhere."""
    x, w, labels, _ = worker.inputs(off, torch.float32, v_pad=128)
    m, s, ll = ops.lm_head_xent(x, w, labels, off, worker.VOCAB)
    logits = x @ w
    keep = torch.arange(128) + off < worker.VOCAB
    logits = torch.where(keep, logits, -1e30)
    torch.testing.assert_close(m, logits.max(-1).values)
    torch.testing.assert_close(
        s, torch.exp(logits - logits.max(-1, keepdim=True).values).sum(-1))
    local = labels - off
    on = (local >= 0) & (local < 128)
    want = logits.gather(-1, local.clamp(0, 127)[..., None])[..., 0]
    torch.testing.assert_close(ll, torch.where(on, want, 0.0))
    assert (ll[~on] == 0).all()


def test_tp2_and_sp_over_gloo_match_plain_formula(tmp_path):
    """Two gloo ranks of a model axis, each with half the 256 columns (the
    labels fall on both shards, 6 padded columns on rank 1): the TP loss
    and SP's ``skip_gcopy`` loss, accuracy and every gradient as the
    materialised formula's over the same collectives."""
    mp.start_processes(worker.tp_main, args=(2, str(tmp_path)), nprocs=2,
                       start_method="spawn")
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for case in ("tp", "sp"):
            for key in ("loss", "acc", "dx", "dw"):
                np.testing.assert_allclose(
                    got[f"new_{case}_{key}"], got[f"plain_{case}_{key}"],
                    rtol=1e-5, atol=1e-7, err_msg=f"rank {r} {case} {key}")


# --------------------------------------------------------------------------
# the three-piece split
# --------------------------------------------------------------------------

def _f32(bits):
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32))


@pytest.mark.parametrize("kind", ["normal", "large", "negative", "small"])
def test_split_sums_back_bitwise(kind):
    """hi + mid + lo is the f32 value bitwise, over the whole exponent
    range down to 2^-110 (every normal value whose last piece bf16 still
    holds), the largest finite f32 values and negative ones; each piece
    is exactly a bf16 value."""
    rng = np.random.default_rng(0)
    mant = rng.integers(0, 1 << 23, 4096, dtype=np.uint32)
    lo_exp = {"normal": 17, "large": 200, "negative": 17, "small": 17}[kind]
    hi_exp = {"normal": 254, "large": 254, "negative": 254, "small": 40}[kind]
    exp = rng.integers(lo_exp, hi_exp + 1, 4096, dtype=np.uint32)
    sign = np.uint32(1 << 31) if kind == "negative" else np.uint32(0)
    v = _f32(sign | (exp << 23) | mant)
    if kind == "large":
        v = torch.cat([v, torch.tensor([torch.finfo(torch.float32).max,
                                        -torch.finfo(torch.float32).max])])
    hi, mid, lo = ref.split3(v)
    total = hi.float() + mid.float() + lo.float()
    assert torch.equal(total.view(torch.int32), v.view(torch.int32))
    assert torch.isfinite(hi.float()).all()


def test_split_of_subnormals():
    """Subnormal f32 values: those bf16 holds split bitwise; the others
    lose only what lies below bf16's smallest subnormal, 2^-133."""
    rng = np.random.default_rng(1)
    mant = rng.integers(1, 1 << 23, 4096, dtype=np.uint32)
    v = torch.cat([_f32(mant), _f32(mant & 0x7F0000), -_f32(mant)])
    hi, mid, lo = ref.split3(v)
    total = (hi.double() + mid.double() + lo.double())
    err = (total - v.double()).abs()
    assert float(err.max()) < 2.0 ** -133
    exact = _f32(mant & 0x7F0000)
    h, m, lo2 = ref.split3(exact)
    assert torch.equal(h.float() + m.float() + lo2.float(), exact)


# --------------------------------------------------------------------------
# the dry run's stand-in launches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_meta_path_records_one_launch_each_way(dtype):
    """A meta x takes no kernel: the forward and the backward each hand one
    stand-in launch, priced by ``kernel_cost.lm_head_xent_cost``, to the
    recorders, and the launch counts stay where they were."""
    t, d, v = 256, 64, 512
    x = torch.empty(2, t // 2, d, dtype=dtype, device="meta",
                    requires_grad=True)
    w = torch.empty(d, v, device="meta", requires_grad=True)
    labels = torch.empty(2, t // 2, dtype=torch.int64, device="meta")
    before = build.launch_counts()
    with build.recording() as rec:
        m, s, ll = ops.lm_head_xent(x, w, labels, 0, v)
        assert rec == [("lm_head_xent_fwd", kernel_cost.lm_head_xent_cost(
            t, d, v, x.element_size(), dtype == torch.bfloat16, False))]
        (s.sum() + ll.sum()).backward()
    assert [r[0] for r in rec] == ["lm_head_xent_fwd", "lm_head_xent_bwd"]
    assert rec[1][1] == kernel_cost.lm_head_xent_cost(
        t, d, v, x.element_size(), dtype == torch.bfloat16, True)
    assert m.shape == s.shape == ll.shape == labels.shape
    assert x.grad.shape == x.shape and x.grad.dtype == dtype
    assert w.grad.shape == w.shape
    assert build.launch_counts() == before


def test_cost_counts_the_tensor_core_products():
    """Three bf16 products a forward for a bf16 x (six otherwise), and
    three times as many a backward (the logits again, dX, dW)."""
    t, d, v = 16384, 1024, 30528
    unit = 2.0 * t * d * v
    assert kernel_cost.lm_head_xent_cost(t, d, v, 2, True, False).flops \
        == 3 * unit
    assert kernel_cost.lm_head_xent_cost(t, d, v, 2, True, True).flops \
        == 9 * unit
    assert kernel_cost.lm_head_xent_cost(t, d, v, 4, False, True).flops \
        == 18 * unit
    assert kernel_cost.lm_head_xent_cost(t, d, v, 2, True, True).kernels \
        == 3 * 4


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _card_inputs(card, t, d, v_l, vocab, off, dtype, seed, w_std=0.02):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(t, d, generator=gen, device=card).to(dtype)
    w = torch.randn(d, v_l, generator=gen, device=card) * w_std
    labels = torch.randint(0, vocab, (t,), generator=gen, device=card)
    mask = (torch.rand(t, generator=gen, device=card) > 0.5).float()
    return x, w, labels, mask


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


# (T, d, V_l, vocab, off, dtype): ragged edges everywhere; BERT-Large's
# head on 2,048 rows; internlm2-1.8b's rank-1 shard on 1,024 rows; the
# split x of f32 and fp16
KERNEL_CASES = [
    (300, 72, 200, 190, 0, torch.bfloat16),
    (4500, 64, 130, 400, 128, torch.bfloat16),
    (2048, 1024, 30528, 30522, 0, torch.bfloat16),
    (1024, 2048, 46272, 92544, 46272, torch.bfloat16),
    (300, 72, 200, 190, 0, torch.float32),
    (260, 136, 300, 290, 0, torch.float16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,v_l,vocab,off,dtype", KERNEL_CASES)
def test_kernels_match_plain(card, t, d, v_l, vocab, off, dtype):
    """The kernels' (m_l, s_l, ll_l), dX and dW against the plain version
    on the card (f32 matmuls, TF32 off): the statistics at f32 rounding
    (atol 2e-5 on logits of ~1, rtol 2e-5 on s), dW at 1e-5 of its norm;
    dX at 1e-4 of its norm for a bf16 x (three of the nine split products:
    2^-16 relative, under the bf16 rounding x's gradient takes) and 1e-5
    for the six-term form; one launch counted each way."""
    from repro_torch.kernels.lm_head_xent import kernel as K
    x, w, labels, _ = _card_inputs(card, t, d, v_l, vocab, off, dtype, 0,
                                   w_std=0.5 / d ** 0.5)
    local = labels - off
    lab = torch.where((local >= 0) & (local < v_l), local, -1).int()
    n_keep = min(max(vocab - off, 0), v_l)
    m, s, ll, saved = K.forward(x, w, lab, n_keep)
    m0, s0, ll0 = ref.forward(x, w, lab, n_keep)
    torch.testing.assert_close(m, m0, rtol=0, atol=2e-5)
    torch.testing.assert_close(s, s0, rtol=2e-5, atol=0)
    torch.testing.assert_close(ll, ll0, rtol=0, atol=2e-5)
    gen = torch.Generator(device=card).manual_seed(1)
    a = torch.rand(t, generator=gen, device=card) / t
    b = -torch.rand(t, generator=gen, device=card) / t
    dx, dw = K.backward(saved, lab, n_keep, m, a, b, d)
    dx0, dw0 = ref.backward(x, w, lab, n_keep, m0, a, b)
    assert _rel(dx, dx0) < (1e-4 if dtype == torch.bfloat16 else 1e-5)
    assert _rel(dw, dw0) < 1e-5
    before = build.launch_counts()
    xg = x.detach().clone().requires_grad_()
    wg = w.detach().clone().requires_grad_()
    _, s1, ll1 = ops.lm_head_xent(xg, wg, labels, off, vocab)
    (s1.sum() - ll1.sum()).backward()
    after = build.launch_counts()
    assert after["lm_head_xent_fwd"] == before["lm_head_xent_fwd"] + 1
    assert after["lm_head_xent_bwd"] == before["lm_head_xent_bwd"] + 1
    torch.cuda.synchronize()


def _per_row_nll_old(x, w, labels, vocab):
    return ref.plain_nll(x, w, labels, vocab)[0]


def _per_row_nll_new(x, w, labels, vocab):
    m, s, ll = ops.lm_head_xent(x, w, labels, 0, vocab)
    return torch.log(s) + m - ll


def _loss_grads(nll_fn, x, w, labels, mask, vocab):
    x = x.detach().clone().requires_grad_()
    w = w.detach().clone().requires_grad_()
    nll = nll_fn(x, w, labels, vocab)
    loss = (nll * mask).sum() / mask.sum()
    loss.backward()
    return nll.detach(), loss.detach(), x.grad, w.grad


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,v,vocab", [(2048, 1024, 30528, 30522),
                                         (1024, 2048, 46272, 46272)])
def test_precision_no_worse_than_twice_the_f32_path(card, t, d, v, vocab):
    """Against float64 (x exact in bf16, w and the whole formula in f64),
    the kernels' errors are at most twice the f32 torch path's: the
    per-row losses and dW by the norm of the error, dX as the bf16
    gradient x receives, and the masked mean loss (with a floor of one
    f32 ulp: a single scalar's error can vanish by chance)."""
    x, w, labels, mask = _card_inputs(card, t, d, v, vocab, 0,
                                      torch.bfloat16, 3)
    nll64, loss64, dx64, dw64 = _loss_grads(
        _per_row_nll_old, x.double(), w.double(), labels, mask.double(),
        vocab)
    nll32, loss32, dx32, dw32 = _loss_grads(_per_row_nll_old, x, w, labels,
                                            mask, vocab)
    nllk, lossk, dxk, dwk = _loss_grads(_per_row_nll_new, x, w, labels, mask,
                                        vocab)
    assert dxk.dtype == dx32.dtype == torch.bfloat16
    errs = {}
    for name, k, f, e in (("nll", nllk, nll32, nll64), ("dx", dxk, dx32, dx64),
                          ("dw", dwk, dw32, dw64)):
        errs[name] = (_rel(k, e), _rel(f, e))
    ulp = float(torch.finfo(torch.float32).eps) * abs(float(loss64))
    errs["loss"] = (abs(float(lossk) - float(loss64)),
                    max(abs(float(loss32) - float(loss64)), ulp))
    print({k: (f"{a:.3e}", f"{b:.3e}") for k, (a, b) in errs.items()})
    for name, (kern, f32) in errs.items():
        assert kern <= 2 * f32, (name, kern, f32)


@pytest.mark.cuda
def test_bert_head_step_runs_no_f32_gemm_and_holds_no_logits(card):
    """BERT-Large's head and loss at 128 x 128 tokens, forward and
    backward through ``vocab_parallel_xent``: every device kernel is the
    head's own or an elementwise one (no f32 GEMM: no ``f32f32``,
    ``sgemm`` or other GEMM name), both head kernels ran, and the step's
    peak memory above its inputs stays under one T x V_l f32 tensor
    (2.0 GB), the logits the f32 path held several times over."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.benchmarks.lm_head_bench import CASES
    _, t, d, v_l, vocab = CASES[0]
    cfg = worker.config(vocab)
    x, w, labels, mask = _card_inputs(card, t, d, v_l, vocab, 0,
                                      torch.bfloat16, 5)
    x.requires_grad_()
    w.requires_grad_()

    def step():
        loss, _ = vocab_parallel_xent(x[None], w, labels[None], mask[None],
                                      cfg)
        loss.backward()

    step()
    torch.cuda.synchronize()
    x.grad = w.grad = None
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    names = {e.key for e in prof.key_averages()}
    assert any("lm_head_xent_kernel" in n for n in names), names
    gemms = [n for n in names if any(
        k in n.lower() for k in ("gemm", "xmma", "cutlass", "nvjet"))]
    assert not gemms, gemms
    assert peak < t * v_l * 4, peak
