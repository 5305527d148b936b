"""Linear models and least-squares estimators, resident fits.

Counterpart of ``keystone_tpu/nodes/learning/linear.py`` (reference
``nodes/learning/LinearMapper.scala`` and ``BlockLinearMapper.scala``):
mean-centered normal equations solved by Cholesky, and block coordinate
descent over feature blocks, fitted on resident data or streamed chunk
by chunk through a ``(G, C, sx, sy, n)`` Gram carry.

Quantized predict: a fitted mapper may apply its weights at a narrower
type than float32 (``weight_dtype="bf16"``, or ``"int8"`` with
per-column scales), as the serving plane does by default. The weights
are quantized on first use on a device; the apply then goes through
``ops.kernels.quantized_affine`` (the CUDA kernel on the card, its plain
version on the CPU), dequantizing and accumulating in float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...observability.metrics import MetricsRegistry
from ...observability.numerics import record_block_health
from ...ops import linalg
from ...ops.kernels import gram_cross, quant_plan, quantized_affine
from ...parallel.dataset import ArrayDataset, Dataset, ensure_array
from ...utils.donation import donates_carry
from ...workflow.label_estimator import LabelEstimator
from ...workflow.operators import tensor_token
from ...workflow.transformer import Transformer
from ..stats import StandardScalerModel


def _affine_params(W, mean, inv_std, b, device):
    """(W, mean, inv_std, b) as float32 tensors on ``device``, with the
    identity filled in for absent terms."""
    def on(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    Wd = on(W)
    d, k = Wd.shape
    return (
        Wd,
        torch.zeros(d, device=device) if mean is None else on(mean),
        torch.ones(d, device=device) if inv_std is None else on(inv_std),
        torch.zeros(k, device=device) if b is None else on(b),
    )


def _affine(params, x):
    W, mean, inv_std, b = params
    return ((x - mean) * inv_std) @ W + b


# -- quantized predict (serving plane) --------------------------------------
#
# Weights stored at float32 and narrowed on the apply path: bf16, or int8
# with per-column scales. The quantization error is recorded the moment
# the weights narrow (``numerics.quant_rel_error`` gauge and a
# ``numerics.quant_error`` count); the parity bars against the float32
# apply are pinned by tests/test_torch_quantized.py.

def _canon_weight_dtype(weight_dtype):
    """None, ``"bf16"`` or ``"int8"``; any other spelling raises."""
    if weight_dtype is None:
        return None
    alias = {"bf16": "bf16", "bfloat16": "bf16", "int8": "int8"}
    if isinstance(weight_dtype, torch.dtype):
        key = {torch.bfloat16: "bf16", torch.int8: "int8"}.get(weight_dtype)
    elif isinstance(weight_dtype, str):
        key = alias.get(weight_dtype)
    else:
        try:
            key = alias.get(str(np.dtype(weight_dtype)))
        except TypeError:
            key = alias.get(str(weight_dtype))
    if key is None:
        raise ValueError(
            f"weight_dtype must be None, 'bf16' or 'int8', got "
            f"{weight_dtype!r}")
    return key


def _quantize_weights(W, weight_dtype):
    """Quantize a fitted (d, k) float32 weight tensor: bf16
    (round-to-nearest-even, scales of ones), or int8 with per-COLUMN
    symmetric scales (``amax / 127``, 1 where a column is all zero;
    ``round`` half to even, clipped to +-127). Returns ``(Wq, scale)`` on
    W's device and records the dequantization error."""
    Wf = W.to(torch.float32)
    k = Wf.shape[1]
    if weight_dtype == "bf16":
        Wq = Wf.to(torch.bfloat16)
        scale = torch.ones(k, dtype=torch.float32, device=Wf.device)
    else:
        amax = Wf.abs().amax(dim=0)
        scale = torch.where(amax > 0.0, amax / 127.0,
                            torch.ones_like(amax))
        Wq = torch.clamp(torch.round(Wf / scale[None, :]), -127.0,
                         127.0).to(torch.int8)
    _record_quant_error(Wf, Wq, scale)
    return Wq, scale


def _record_quant_error(Wf, Wq, scale):
    """Largest dequantization error relative to the largest weight, into
    the ``numerics.quant_rel_error`` gauge, and one
    ``numerics.quant_error`` count."""
    deq = Wq.to(torch.float32) * scale[None, :]
    denom = max(float(Wf.abs().max()) if Wf.numel() else 0.0, 1e-12)
    err = float((deq - Wf).abs().max()) if Wf.numel() else 0.0
    reg = MetricsRegistry.get_or_create()
    reg.gauge("numerics.quant_rel_error").set(err / denom)
    reg.counter("numerics.quant_error").inc()


def _maybe_quantized_params(affine, weight_dtype, quantized=None):
    """The apply-params tail of both mappers: the float32 4-tuple
    ``(W, mean, inv_std, b)`` as it is when no weight_dtype is set, else
    the quantized 5-tuple ``(Wq, scale, mean, inv_std, b)`` on the CPU
    and, on a CUDA device, the kernel's ``QuantPlan`` alone in a 1-tuple
    (the operands laid out as the kernel reads them, made once per model
    and device, so the weights live on the card once); ``quantized``
    holds a given ``(Wq, scale)`` pair (a model carried across already
    quantized), used instead of quantizing W. ``quantized_affine(X,
    *params)`` takes either form."""
    if weight_dtype is None:
        return affine
    W, mean, inv_std, b = affine
    if quantized is None:
        Wq, scale = _quantize_weights(W, weight_dtype)
    else:
        Wq = torch.as_tensor(quantized[0]).to(W.device)
        scale = torch.as_tensor(quantized[1], dtype=torch.float32,
                                device=W.device)
    # the kernel takes contiguous operands; a solve may leave W (and so
    # Wq) column-major
    params = tuple(t.contiguous() for t in (Wq, scale, mean, inv_std, b))
    plan = quant_plan(*params)
    return params if plan is None else (plan,)


def _dequant_affine(params, x):
    """The per-item quantized apply, through the batch's wrapper
    (``ops.kernels.quantized_affine``: a one-row launch on the card, the
    plain version on the CPU), so the two paths cannot diverge."""
    return quantized_affine(x.reshape(1, -1).contiguous(), *params)[0]


def _host(v):
    return v.cpu() if isinstance(v, torch.Tensor) else v


class LinearMapper(Transformer):
    """out = x_model^T in (+ b), with optional feature scaler
    (reference ``LinearMapper.scala:18-62``). ``weight_dtype`` narrows
    the weights on the apply path (None = float32; ``"bf16"`` /
    ``"int8"``, see ``_quantize_weights``); ``quantized`` is an already
    quantized ``(Wq, scale)`` pair to apply instead (``convert.py``)."""

    def __init__(self, weights, intercept=None,
                 feature_scaler: Optional[StandardScalerModel] = None,
                 weight_dtype: Optional[str] = None, quantized=None):
        self.weights = weights
        self.intercept = intercept
        self.feature_scaler = feature_scaler
        self.weight_dtype = _canon_weight_dtype(weight_dtype)
        self.quantized = quantized
        if (self.weight_dtype is not None and feature_scaler is not None
                and type(feature_scaler) is not StandardScalerModel):
            raise ValueError(
                "weight_dtype quantization requires a plain "
                "StandardScalerModel feature scaler (or none): the "
                "quantized apply is one fused affine")

    def eq_key(self):
        return (LinearMapper, self.weight_dtype, tensor_token(self.weights),
                tensor_token(self.intercept),
                None if self.feature_scaler is None
                else self.feature_scaler._cached_eq_key(),
                None if self.quantized is None
                else tuple(tensor_token(q) for q in self.quantized))

    def struct_key(self):
        """The apply's program family: every float32 mapper shares one,
        each weight type has its own."""
        return (LinearMapper, "affine", self.weight_dtype)

    def apply(self, x):
        if self.weight_dtype is not None:
            return _dequant_affine(self.apply_params(x.device), x)
        if self.feature_scaler is not None:
            x = self.feature_scaler.apply(x)
        W, _, _, b = self.apply_params(x.device)
        return x @ W + b

    def apply_params(self, device):
        def build(d):
            s = self.feature_scaler
            mean = None if s is None else s.mean
            inv = (None if s is None or s.std is None
                   else 1.0 / np.asarray(s.std))
            return _maybe_quantized_params(
                _affine_params(self.weights, mean, inv, self.intercept, d),
                self.weight_dtype, self.quantized)
        return self._params_on(device, build)

    def apply_batch(self, X):
        params = self.apply_params(X.device)
        if self.weight_dtype is not None:
            return quantized_affine(X, *params)
        return _affine(params, X)

    def __getstate__(self):
        # device tensors pickle as host copies
        d = super().__getstate__()
        for f in ("weights", "intercept"):
            d[f] = _host(d[f])
        if d["quantized"] is not None:
            d["quantized"] = tuple(_host(q) for q in d["quantized"])
        return d


class LinearMapEstimator(LabelEstimator):
    """OLS/ridge via normal equations on mean-centered features and
    labels; intercept = label mean (reference ``LinearMapper.scala:71-98``)."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    # -- static HBM planning (analysis.resources) --------------------------
    def carry_nbytes(self, dep_specs):
        from ...analysis.resources import gram_carry_nbytes

        return gram_carry_nbytes(dep_specs)

    def fitted_nbytes(self, dep_specs):
        from ...analysis.resources import linear_model_nbytes

        return linear_model_nbytes(dep_specs)

    def __init__(self, lam: Optional[float] = None,
                 weight_dtype: Optional[str] = None):
        self.lam = lam
        # checked here, so a typo fails before the fit, not after it
        self.weight_dtype = _canon_weight_dtype(weight_dtype)

    # -- streaming fit (accumulate/finalize protocol) ----------------------
    def accumulate(self, carry, chunk, labels):
        """One chunk's contribution to the raw Gram / cross / sum carry,
        through the fused Gram kernel, in place."""
        return accumulate_gram_carry(carry, chunk, labels)

    def finalize(self, carry) -> LinearMapper:
        """Centered ridge normal equations from the accumulated raw
        moments, Gc = G - n mu_x mu_x^T and Cc = C - n mu_x mu_y^T:
        algebraically the resident ``_fit``, with only the (d, d) + (d, k)
        carry on the device. Consumes the carry (centered in place)."""
        x_mean, y_mean, Gc, Cc = _centered_carry(carry)
        W = linalg.ridge_cho_solve(Gc, Cc, float(self.lam or 0.0))
        return LinearMapper(W, intercept=y_mean,
                            feature_scaler=StandardScalerModel(
                                x_mean.cpu().numpy()),
                            weight_dtype=self.weight_dtype)

    #: Serial device rounds of the JAX package's exact fit (center, gram,
    #: factorize, solve, intercept and the eigendecomposition's host
    #: syncs): the program's structure, read only with a nonzero
    #: ``lat_w``, which the port's default weights do not have.
    DISPATCH_ROUNDS = 10

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w,
             lat_w=0.0) -> float:
        """Reference cost model (LinearMapper.scala:100-115), with the
        JAX package's term of ``lat_w`` seconds per serial device round
        (``lat_w = 0`` is the reference surface)."""
        flops = n * d * (d + k) / num_machines
        bytes_scanned = n * d / num_machines + d * d
        network = d * (d + k)
        return (max(cpu_w * flops, mem_w * bytes_scanned) + net_w * network
                + lat_w * self.DISPATCH_ROUNDS)

    def _fit(self, ds: Dataset, labels: Dataset) -> LinearMapper:
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        n = ds.n
        X, Y = ds.data.to(torch.float32), labels.data.to(torch.float32)
        m = ds.mask[:, None].to(X.dtype)
        x_mean = (X * m).sum(dim=0) / n
        y_mean = (Y * m).sum(dim=0) / n
        Xc = (X - x_mean) * m
        Yc = (Y - y_mean) * m
        W = linalg.ridge_cho_solve(linalg.gram(Xc), linalg.cross(Xc, Yc),
                                   float(self.lam or 0.0))
        return LinearMapper(W, intercept=y_mean,
                            feature_scaler=StandardScalerModel(
                                x_mean.cpu().numpy()),
                            weight_dtype=self.weight_dtype)


class BlockLinearMapper(Transformer):
    """Block-partitioned linear model (reference
    ``BlockLinearMapper.scala:22-73``). The blocks concatenate into one
    weight matrix applied as one GEMM; the per-block view is kept for API
    parity. ``weight_dtype`` and ``quantized`` as in LinearMapper."""

    def __init__(self, block_weights: Sequence, block_size: int,
                 intercept=None, feature_means=None,
                 weight_dtype: Optional[str] = None, quantized=None):
        self.block_weights = list(block_weights)
        self.block_size = block_size
        self.intercept = intercept
        self.feature_means = feature_means
        self.weight_dtype = _canon_weight_dtype(weight_dtype)
        self.quantized = quantized
        if any(isinstance(w, torch.Tensor) for w in self.block_weights):
            self.weights = torch.cat([torch.as_tensor(w)
                                      for w in self.block_weights], dim=0)
        else:
            self.weights = np.concatenate(self.block_weights, axis=0)

    def eq_key(self):
        return (BlockLinearMapper, self.block_size, self.weight_dtype,
                tensor_token(self.weights), tensor_token(self.intercept),
                tensor_token(self.feature_means),
                None if self.quantized is None
                else tuple(tensor_token(q) for q in self.quantized))

    def struct_key(self):
        """The apply's program family, as LinearMapper's."""
        return (BlockLinearMapper, "affine", self.weight_dtype)

    def apply_params(self, device):
        return self._params_on(device, lambda d: _maybe_quantized_params(
            _affine_params(self.weights, self.feature_means, None,
                           self.intercept, d),
            self.weight_dtype, self.quantized))

    def apply(self, x):
        params = self.apply_params(x.device)
        if self.weight_dtype is not None:
            return _dequant_affine(params, x)
        W, mean, _, b = params
        return (x - mean) @ W + b

    def apply_batch(self, X):
        params = self.apply_params(X.device)
        if self.weight_dtype is not None:
            return quantized_affine(X, *params)
        return _affine(params, X)

    def __getstate__(self):
        # device tensors pickle as host copies
        d = super().__getstate__()
        d["block_weights"] = [_host(w) for w in self.block_weights]
        for f in ("weights", "intercept", "feature_means"):
            d[f] = _host(d[f])
        if d["quantized"] is not None:
            d["quantized"] = tuple(_host(q) for q in d["quantized"])
        return d


class BlockLeastSquaresEstimator(LabelEstimator):
    """The workhorse solver (reference ``BlockLinearMapper.scala:196-257``):
    per-block mean-centering, label mean-centering, block coordinate
    descent with L2, intercept from the joint means."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    # -- static HBM planning (analysis.resources) --------------------------
    def carry_nbytes(self, dep_specs):
        from ...analysis.resources import gram_carry_nbytes

        return gram_carry_nbytes(dep_specs)

    def fitted_nbytes(self, dep_specs):
        from ...analysis.resources import linear_model_nbytes

        return linear_model_nbytes(dep_specs)

    def __init__(self, block_size: int, num_iter: int, lam: float = 0.0,
                 weight_dtype: Optional[str] = None):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.weight_dtype = _canon_weight_dtype(weight_dtype)

    @property
    def weight(self) -> int:
        """Passes over the input a fit makes, for auto-caching's run
        counts (the JAX package's weight)."""
        return 3 * self.num_iter + 1

    # -- streaming fit (accumulate/finalize protocol) ----------------------
    def accumulate(self, carry, chunk, labels):
        """The same carry as the exact solver: raw Gram, cross products
        and sums. The carry is (d, d): streaming bounds device memory in
        the row count n, not in d."""
        return accumulate_gram_carry(carry, chunk, labels)

    def finalize(self, carry) -> BlockLinearMapper:
        """Block coordinate descent from the carry (``gram_bcd``);
        consumes the carry."""
        d = carry[0].shape[0]
        bs = self.block_size
        bounds = [(i, min(d, i + bs)) for i in range(0, d, bs)]
        Ws, x_mean, y_mean = gram_bcd(carry, float(self.lam), bounds,
                                      self.num_iter)
        return BlockLinearMapper(Ws, bs, intercept=y_mean,
                                 feature_means=x_mean,
                                 weight_dtype=self.weight_dtype)

    #: Serial device rounds of the JAX package's BCD fit, which stages the
    #: whole multi-pass solve as one program: its structure, read only
    #: with a nonzero ``lat_w``.
    DISPATCH_ROUNDS = 3

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w,
             lat_w=0.0) -> float:
        """Reference cost model (BlockLinearMapper.scala:268-282), with
        the serial-round term of ``LinearMapEstimator.cost``."""
        flops = n * d * (self.block_size + k) / num_machines
        bytes_scanned = n * d / num_machines + d * k
        network = 2.0 * (d * (self.block_size + k)) * np.log2(
            max(num_machines, 1))
        return self.num_iter * (
            max(cpu_w * flops, mem_w * bytes_scanned) + net_w * network
        ) + lat_w * self.DISPATCH_ROUNDS

    def _fit(self, ds: Dataset, labels: Dataset) -> BlockLinearMapper:
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        d = ds.data.shape[1]
        bs = self.block_size
        bounds = [(i, min(d, i + bs)) for i in range(0, d, bs)]
        Ws, x_mean, y_mean = block_least_squares(
            ds.data, labels.data, ds.n, float(self.lam), bounds,
            self.num_iter, mask=ds.mask)
        # apply() centers x by the means, so the intercept is y_mean
        return BlockLinearMapper(Ws, bs, intercept=y_mean,
                                 feature_means=x_mean,
                                 weight_dtype=self.weight_dtype)


def block_least_squares(X, Y, n, lam, bounds, num_iter, mask=None):
    """Column means over the true ``n`` rows + mean-centered block
    coordinate descent. Returns ``(per-block weights, x_mean, y_mean)``;
    prediction is ``(x - x_mean) @ concat(Ws) + y_mean``."""
    X, Y = X.to(torch.float32), Y.to(torch.float32)
    if mask is None:
        mask = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    x_mean = linalg.distributed_mean(X, n)
    y_mean = linalg.distributed_mean(Y, n)
    m = mask[:, None].to(X.dtype)
    Yc = (Y - y_mean) * m
    blocks = [(X[:, lo:hi] - x_mean[lo:hi]) * m for lo, hi in bounds]
    Ws = linalg.bcd_core(blocks, Yc, lam, num_passes=num_iter)
    return Ws, x_mean, y_mean


# -- streaming carry (shared by the least-squares estimators) --------------
#
# Raw second moments (G = X^T X, C = X^T Y), raw column sums and the true
# row count. Centering is recovered at finalize (Gc = G - n mu mu^T), so
# accumulation is a pure sum: the chunk order changes the result only by
# float32 rounding.

@donates_carry(0)
def accumulate_gram_carry(carry, chunk, labels):
    """Fold one (features, labels) chunk pair into the
    ``(G, C, sx, sy, n)`` carry, in place: the fused Gram kernel adds
    X^T X and X^T Y into G and C (the counterpart of the JAX package's
    donated ``_gram_carry_update``), so no (d, d) temporary is made per
    chunk. ``n`` stays a host int. Chunks must keep the zero-pad
    invariant (stream chunks, or any masked resident dataset)."""
    if not isinstance(chunk, ArrayDataset) or not isinstance(
            labels, ArrayDataset):
        raise TypeError("the Gram carry accumulates ArrayDataset chunks")
    X, Y = chunk.data, labels.data
    if X.dim() != 2 or Y.dim() != 2:
        raise ValueError(
            f"streamed least squares needs 2-D (n, d) / (n, k) chunks, got "
            f"{tuple(X.shape)} / {tuple(Y.shape)}")
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"chunk / labels padded rows differ: {X.shape[0]} "
                         f"vs {Y.shape[0]}")
    if carry is None:
        d, k = X.shape[1], Y.shape[1]

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=X.device)

        carry = (zeros(d, d), zeros(d, k), zeros(d), zeros(k), 0)
    G, C, sx, sy, n = carry
    gram_cross(X, Y, G, C)
    sx += X.sum(dim=0, dtype=torch.float32)
    sy += Y.sum(dim=0, dtype=torch.float32)
    return (G, C, sx, sy, n + chunk.n)


def _centered_carry(carry):
    """``(x_mean, y_mean, Gc, Cc)`` from a raw carry, centering G and C in
    place (``addr_``: no (d, d) outer-product temporary)."""
    G, C, sx, sy, n = carry
    x_mean, y_mean = sx / n, sy / n
    G.addr_(x_mean, x_mean, alpha=-float(n))
    C.addr_(x_mean, y_mean, alpha=-float(n))
    return x_mean, y_mean, G, C


def gram_bcd(carry, lam, bounds, num_iter):
    """Block coordinate descent driven entirely by the Gram carry: the
    update

        W_b <- (Gc[b,b] + lam I)^-1 (Cc[b] - Gc[b,:] W + Gc[b,b] W_b)

    is algebraically the data-form update A_b^T (Yc - P + A_b W_b) of
    ``ops.linalg.bcd_core``, with the same sequential block order, the
    same per-block Cholesky reuse and the same breakdown recovery, so
    streamed and resident fits agree to float32 rounding without the
    (n, d) data ever being resident (``linear.py::_gram_bcd_impl`` in the
    JAX package). Consumes the carry. Returns ``(per-block weights,
    x_mean, y_mean)``."""
    x_mean, y_mean, Gc, Cc = _centered_carry(carry)
    d, k = Cc.shape
    factors, ratios = [], []
    for lo, hi in bounds:
        reg = Gc[lo:hi, lo:hi] + lam * torch.eye(hi - lo, dtype=Gc.dtype,
                                                 device=Gc.device)
        L, ok, ratio = linalg.cholesky_health(reg)
        factors.append((reg, L, ok))
        ratios.append(ratio)
    record_block_health("gram_bcd", [f[2] for f in factors], ratios)
    W = torch.zeros((d, k), dtype=Gc.dtype, device=Gc.device)
    for _ in range(num_iter):
        for (lo, hi), (reg, L, ok) in zip(bounds, factors):
            rhs = (Cc[lo:hi] - Gc[lo:hi, :] @ W
                   + Gc[lo:hi, lo:hi] @ W[lo:hi])
            W[lo:hi] = linalg.finite_or_eigh_solve(
                torch.cholesky_solve(rhs, L), lambda reg=reg: reg, rhs, ok)
    return [W[lo:hi].clone() for lo, hi in bounds], x_mean, y_mean
