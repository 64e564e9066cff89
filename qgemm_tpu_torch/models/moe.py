"""Mixture-of-Experts feed-forward with int8 expert weights (port of
``qgemm_tpu/models/moe.py``).

A GShard/Switch-style top-k routed MoE: a static capacity per expert
(a multiple of 8, from the call's flattened token count, padding
included), k-major capacity order (every first choice is placed before any
second choice), renormalised gates, tokens over capacity dropped (the
residual around the FFN carries them). Experts live in one stacked
``[E, ...]`` tensor.

Dispatch and combine are index operations here where JAX writes one-hot
einsums (``tec,td->ecd`` and ``tec,ecd->td``): each (choice, token) pair
gets a flat slot ``expert * C + position`` (``E * C`` when dropped, a
zero row), dispatch copies token rows into their slots (an exact copy, as
the einsum's sum of one row and zeros is), and combine gathers each
pair's expert output, scales it by its gate and adds the k choices in
choice order. The einsum may contract a product and a sum into one FMA,
so the combined output can differ from JAX's in the last bit; no matrix
product runs in TF32 (the router's product is an f32 ``matmul``; callers
on the card keep ``torch.backends.cuda.matmul.allow_tf32`` False, its
default).

Expert parallelism (``parallel/expert.py``): ``shard_moe`` gives a rank
the layer holding only the E/p experts of its coordinate, the router
whole; its forward runs ``ep_moe_forward`` on the mesh it names (routing
replicated, the rank's experts, one SUM), and ``tp_mode`` is ``"expert"``.

``quantize()`` makes per-expert LLM.int8() absmax weights with kernel K9
(``ops/cuda/col_quantize.py``) and ignores ``bits`` and the outlier
options, as the JAX package does; the quantized expert FFN runs kernel K8
(``ops/cuda/expert_matmul.py``) in the TPU kernel's epilogue order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
from qgemm_tpu_torch.ops.cuda.expert_matmul import quantized_expert_ffn_kernel
from qgemm_tpu_torch.ops.quantize import absmax_quantize
from qgemm_tpu_torch.utils.prng import uniform_init


def _capacity(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: capacity_factor * T * k / E, plus one, rounded up
    to a multiple of 8, at least 8."""
    c = int(capacity_factor * n_tokens * top_k / n_experts) + 1
    return max(8, -(-c // 8) * 8)


def route_slots(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with static capacity, as flat slots. x [T, d],
    router_w [d, E] -> (slot [k*T] int64, gates [k*T] f32), both in
    k-major order (entry j*T + t is token t's j-th choice). A slot is
    ``expert * capacity + position``, or ``E * capacity`` for a choice
    dropped over capacity. Ties in the top-k keep the lower expert index
    (a stable sort), as ``jax.lax.top_k`` does."""
    t = x.shape[0]
    e = router_w.shape[1]
    probs = torch.softmax(torch.matmul(x.to(torch.float32), router_w.to(torch.float32)),
                          dim=-1)                                          # [T, E]
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / topv.sum(dim=-1, keepdim=True)                           # renormalise
    experts = topi.t().reshape(top_k * t)                                  # k-major
    onehot = torch.nn.functional.one_hot(experts, e)                       # [k*T, E]
    pos = (onehot.cumsum(dim=0) - 1).gather(1, experts[:, None])[:, 0]
    slot = torch.where(pos < capacity, experts * capacity + pos,
                       torch.full_like(pos, e * capacity))
    return slot, topv.t().reshape(top_k * t)


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int, capacity: int):
    """JAX ``route``'s contract: x [T, d], router_w [d, E] -> (dispatch
    [T, E, C] in {0, 1}, combine [T, E, C] gate-weighted), built from
    ``route_slots``."""
    t = x.shape[0]
    e = router_w.shape[1]
    slot, gates = route_slots(x, router_w, top_k, capacity)
    oh = torch.nn.functional.one_hot(slot, e * capacity + 1)[:, :-1].to(torch.float32)
    dispatch = oh.reshape(top_k, t, e, capacity).sum(0)
    combine = (oh * gates[:, None]).reshape(top_k, t, e, capacity).sum(0)
    return dispatch, combine


def dispatch(xf: torch.Tensor, slot: torch.Tensor, top_k: int, n_experts: int,
             capacity: int) -> torch.Tensor:
    """Each (choice, token) row of xf [T, d] copied into its flat slot (the
    slot ``n_experts * capacity`` is a dropped choice's, and is cut off)
    -> f32 [n_experts, capacity, d], zero where no token landed."""
    n_slots, d = n_experts * capacity, xf.shape[-1]
    return xf.new_zeros((n_slots + 1, d)).index_copy(0, slot, xf.repeat(top_k, 1))[
        :n_slots].reshape(n_experts, capacity, d)


def combine(expert_out: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
            top_k: int) -> torch.Tensor:
    """Each (choice, token)'s expert output from expert_out [E, C, d] (zero
    for a slot past the end, a dropped choice's), scaled by its gate, the
    k choices added in choice order -> [T, d]."""
    d = expert_out.shape[-1]
    n_slots = expert_out.shape[0] * expert_out.shape[1]
    picked = torch.cat([expert_out.reshape(n_slots, d),
                        expert_out.new_zeros((1, d))]).index_select(0, slot)
    return (picked * gates[:, None]).reshape(top_k, -1, d).sum(dim=0)


def run_experts(expert_in: torch.Tensor, w_up, w_down) -> torch.Tensor:
    """The experts' FFN on their slots: expert_in f32 [E, C, d] -> f32
    [E, C, d]; K8 on CUDA when the weights are ``QuantizedExpertWeight``s,
    the f32 products of ``expert_ffn`` when float."""
    if isinstance(w_up, QuantizedExpertWeight):
        return quantized_expert_ffn(expert_in, w_up, w_down)
    return expert_ffn(expert_in.to(w_up.dtype), w_up, w_down)


def expert_leaf_specs(quantized: bool) -> dict:
    """JAX's sharding rule for an MoE FFN's expert leaves (float [E, ...],
    or the int8 codes [E, in, out] and scales [E, 1, out]): the expert
    dimension on the model axis, as ``PartitionSpec`` tuples by leaf name;
    the router (not named) replicated."""
    leaves = ("w_up/q", "w_up/c", "w_down/q", "w_down/c") if quantized else ("w_up", "w_down")
    return {leaf: ("model", None, None) for leaf in leaves}


def load_balancing_loss(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer auxiliary load-balancing loss: E * sum_e f_e * P_e,
    f_e the fraction of tokens whose top-1 choice is expert e, P_e the mean
    router probability on e. 1.0 at a uniform assignment. x [..., d]."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(torch.matmul(xf.to(torch.float32), router_w.to(torch.float32)),
                          dim=-1)
    e = router_w.shape[1]
    f = torch.nn.functional.one_hot(probs.argmax(dim=-1), e).to(torch.float32).mean(dim=0)
    return e * torch.sum(f * probs.mean(dim=0))


def expert_ffn(expert_in: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
    """Dense per-expert FFN with f32 products, as JAX's
    ``preferred_element_type=float32`` einsums: the operands are upcast
    (a bf16 ``bmm`` would round its output to bf16), the hidden activation
    is rounded to ``w_down``'s dtype before the second product.
    expert_in [E, C, d], w_up [E, d, f], w_down [E, f, d] -> f32 [E, C, d]."""
    h = torch.relu(torch.matmul(expert_in.to(torch.float32), w_up.to(torch.float32)))
    return torch.matmul(h.to(w_down.dtype).to(torch.float32), w_down.to(torch.float32))


class QuantizedExpertWeight(NamedTuple):
    """Per-expert int8 weights and per-(expert, output column) absmax
    scales. The codes are stored K-major (``qt`` [E, out, in], the layout
    kernel K8 reads); ``q`` is the JAX package's [E, in, out] view."""
    qt: torch.Tensor  # int8 [E, out, in]
    c: torch.Tensor   # f32  [E, 1, out]

    @property
    def q(self) -> torch.Tensor:
        return self.qt.transpose(1, 2)

    @classmethod
    def from_kn(cls, q: torch.Tensor, c: torch.Tensor) -> "QuantizedExpertWeight":
        """From JAX's [E, in, out] codes and [E, 1, out] scales."""
        return cls(qt=q.transpose(1, 2).contiguous(), c=c.to(torch.float32))


def quantize_expert_weights(w: torch.Tensor) -> QuantizedExpertWeight:
    """w [E, in, out] -> per-(expert, column) int8 codes and absmax, in f32
    (JAX ``quantize_expert_weights``): kernel K9 on CUDA tensors, one launch
    for all experts."""
    qt, c = col_quantize(w)
    return QuantizedExpertWeight(qt=qt, c=c)


def _row_quantize(x: torch.Tensor):
    """x [..., d] -> (int8, f32 absmax [..., 1]) per trailing row, in f32:
    the activation quantization of the expert products (K8 does it in
    registers; its plain version calls the same ``absmax_quantize``)."""
    return absmax_quantize(x.to(torch.float32), axis=-1)


# The int8 expert FFN of the model path: K8 on CUDA tensors, up (ReLU in
# its epilogue) then down, in the TPU kernel's epilogue order.
quantized_expert_ffn = quantized_expert_ffn_kernel


class MoEFeedForward(nn.Module):
    """Drop-in replacement for ``FeedForward`` with E routed experts.
    Float: ``router_w`` [d, E] (f32 in every model dtype, as in JAX),
    ``w_up`` [E, d, f] and ``w_down`` [E, f, d], all trainable. Quantized:
    the codes and scales as buffers (``w_up_qt``, ``w_up_c``,
    ``w_down_qt``, ``w_down_c``), ``router_w`` frozen."""

    def __init__(self, router_w: torch.Tensor, w_up, w_down, top_k: int = 2,
                 capacity_factor: float = 1.25):
        """``w_up`` / ``w_down`` are float tensors or ``QuantizedExpertWeight``s."""
        super().__init__()
        self.n_experts = router_w.shape[1]
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.is_quantized = isinstance(w_up, QuantizedExpertWeight)
        # expert parallelism (``parallel/expert.py``): a rank's layer holds
        # the E/p experts of its coordinate on the axis
        self.tp_mode = "none"           # "none" | "expert"
        self.tp_axis = "model"
        self.mesh = None
        self.router_w = nn.Parameter(router_w, requires_grad=not self.is_quantized)
        if self.is_quantized:
            for name, wq in (("w_up", w_up), ("w_down", w_down)):
                self.register_buffer(f"{name}_qt", wq.qt)
                self.register_buffer(f"{name}_c", wq.c)
        else:
            self.w_up = nn.Parameter(w_up)
            self.w_down = nn.Parameter(w_down)

    @classmethod
    def init(cls, generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             top_k: int = 2, capacity_factor: float = 1.25,
             dtype: torch.dtype = torch.float32) -> "MoEFeedForward":
        """Kaiming-uniform ±1/sqrt(fan_in) from ``generator``; router in f32."""
        bound_in = 1.0 / (d_model ** 0.5)
        bound_ff = 1.0 / (d_ff ** 0.5)
        return cls(uniform_init(generator, (d_model, n_experts), bound_in, torch.float32),
                   uniform_init(generator, (n_experts, d_model, d_ff), bound_in, dtype),
                   uniform_init(generator, (n_experts, d_ff, d_model), bound_ff, dtype),
                   top_k=top_k, capacity_factor=capacity_factor)

    def expert_weights(self):
        """(w_up, w_down): float parameters, or ``QuantizedExpertWeight``s
        (the layer's own experts: a rank's under expert parallelism)."""
        if self.is_quantized:
            return (QuantizedExpertWeight(self.w_up_qt, self.w_up_c),
                    QuantizedExpertWeight(self.w_down_qt, self.w_down_c))
        return self.w_up, self.w_down

    @property
    def n_local_experts(self) -> int:
        return self.expert_weights()[0].c.shape[0] if self.is_quantized else self.w_up.shape[0]

    @property
    def leaf_specs(self):
        """The expert leaves' specs where this layer holds a rank's experts
        (``expert_leaf_specs``); nothing sharded otherwise."""
        return expert_leaf_specs(self.is_quantized) if self.tp_mode == "expert" else {}

    def quantize(self, **_qkw) -> "MoEFeedForward":
        """int8 expert weights (K9), keeping the layer's expert placement.
        ``bits`` and the outlier options are accepted and ignored, as by the
        JAX package: they apply to the attention projections and
        ``lm_head`` only."""
        if self.is_quantized:
            return self
        out = MoEFeedForward(self.router_w.data, quantize_expert_weights(self.w_up.data),
                             quantize_expert_weights(self.w_down.data), top_k=self.top_k,
                             capacity_factor=self.capacity_factor)
        out.n_experts = self.n_experts
        out.tp_mode, out.tp_axis, out.mesh = self.tp_mode, self.tp_axis, self.mesh
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., d] -> [..., d] in x's dtype. The tokens are flattened
        row-major, and the capacity follows their count. A rank's layer of
        an expert-sharded one runs ``ep_moe_forward`` on its mesh."""
        if self.tp_mode == "expert":
            from qgemm_tpu_torch.parallel.expert import ep_moe_forward
            return ep_moe_forward(x, self, self.mesh, self.tp_axis)
        shape = x.shape
        xf = x.reshape(-1, shape[-1]).to(torch.float32)
        cap = _capacity(xf.shape[0], self.n_experts, self.top_k, self.capacity_factor)
        slot, gates = route_slots(xf, self.router_w, self.top_k, cap)
        expert_in = dispatch(xf, slot, self.top_k, self.n_experts, cap)
        out = combine(run_experts(expert_in, *self.expert_weights()), slot, gates, self.top_k)
        return out.reshape(shape).to(x.dtype)

    def aux_loss(self, x: torch.Tensor) -> torch.Tensor:
        """The Switch load-balancing loss of this layer's router on ``x``
        (``load_balancing_loss``); kept out of ``forward``, as in JAX."""
        return load_balancing_loss(x, self.router_w)
