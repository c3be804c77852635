"""Min-sum decoding, layered and flooding, in plain PyTorch.

Both take channel LLRs (B, n), float32, and return the decoder's answer
for each frame: ``codeword`` (B, n) uint8 hard decisions (bit 1 where the
posterior is <= 0), ``iterations`` (B,) int32 and ``success`` (B,) bool.
Iteration 0 tests the channel's hard decisions; a frame stops at the
first iteration whose hard decisions satisfy every check and keeps them;
a frame that never does reports ``max_iterations`` and its last hard
decisions.

The check rule is min-sum: each output has the smallest magnitude of the
check's other inputs and the product of their signs (x < 0 counts as
negative). A lane with no edge feeds the
check the storage type's largest value and takes 0 back. Messages are
stored in ``storage`` (bfloat16 for the ``*bf16`` decoders) and computed
in float32:

* layered: the posteriors Qv (float32) start at the LLRs; a check group's
  inputs are Qv - Rold, all formed before the group updates; the new
  message Rnew is kept in storage, and Qv += Rnew - Rold (Rnew in float32,
  Rold as stored) slot by slot, so two edges of one group into one column
  add in turn;
* flooding: the LLRs are cast to storage first (the channel planes and
  the iteration-0 decisions come from the cast values); variable-to-check
  messages start at the LLR; an iteration runs every check, then every
  variable: the posterior is the LLR plus the incoming messages summed in
  slot order, each outgoing message the posterior less its own input.

A storage type narrower than bfloat16 (the float8 types of the control)
is kept in float32 tensors holding values rounded through it. Frames are
decoded in blocks (``LAYERED_BLOCK``, ``FLOODING_BLOCK``) so that the
temporaries fit.
"""

from __future__ import annotations

import torch

__all__ = ["flooding_decode", "layered_decode"]

LAYERED_BLOCK, FLOODING_BLOCK = 1024, 512


def _container(storage):
    """The tensor type that holds messages of ``storage``."""
    return storage if torch.finfo(storage).bits >= 16 else torch.float32


def _stored(x, storage):
    """``x`` rounded to ``storage``, in its container type."""
    return x.to(storage).to(_container(storage))


def _check(x, valid, big):
    """(R, d, B) float32 inputs -> min-sum outputs, 0 where ``valid`` is
    False; ``big`` caps the second smallest magnitude."""
    mag = x.abs()
    m1, arg = mag.min(dim=1, keepdim=True)
    slot = torch.arange(x.shape[1], device=x.device)[None, :, None]
    mine = slot == arg
    m2 = torch.where(mine, big, mag).amin(dim=1, keepdim=True)
    loo = torch.where(mine, m2, m1)
    neg = x < 0
    odd = (neg.sum(dim=1, keepdim=True, dtype=torch.int32) & 1).bool()
    out = torch.where(odd ^ neg, -loo, loo)
    return torch.where(valid, out, 0.0)


def _syndrome_ok(hard, tables):
    """(n + 1, B) bool hard decisions (row n False) -> (B,) every check
    satisfied; ``tables`` the (cols (R, d)) of the check buckets."""
    ok = torch.ones(hard.shape[1], dtype=torch.bool, device=hard.device)
    for cols in tables:
        par = hard[cols].sum(dim=1, dtype=torch.int32) & 1
        ok &= ~par.bool().any(dim=0)
    return ok


class _Stop:
    """The per-frame stop rule over (n + 1, B) hard decisions."""

    def __init__(self, hard0, tables, max_iterations):
        self.tables = tables
        self.max_iterations = max_iterations
        self.conv = _syndrome_ok(hard0, tables)
        self.iters = torch.zeros(hard0.shape[1], dtype=torch.int32, device=hard0.device)
        self.frozen = hard0
        self.hard = hard0
        self.it = 0

    def running(self) -> bool:
        return self.it < self.max_iterations and not bool(self.conv.all())

    def test(self, hard):
        self.it += 1
        self.hard = hard
        ok = _syndrome_ok(hard, self.tables)
        newly = ok & ~self.conv
        self.iters = torch.where(newly, self.it, self.iters)
        self.frozen = torch.where(newly, hard, self.frozen)
        self.conv = self.conv | ok

    def answer(self, n):
        bits = torch.where(self.conv, self.frozen, self.hard)[:n]
        iters = torch.where(self.conv, self.iters, self.max_iterations)
        return bits.T.contiguous().to(torch.uint8), iters.to(torch.int32), self.conv.clone()


def _blocks(decode, llr, block):
    outs = [decode(llr[i : i + block]) for i in range(0, llr.shape[0], block)]
    return {
        "codeword": torch.cat([o[0] for o in outs]),
        "iterations": torch.cat([o[1] for o in outs]),
        "success": torch.cat([o[2] for o in outs]),
    }


def _device_tables(graph, device):
    layers = [
        (torch.as_tensor(cols, device=device),
         torch.as_tensor(edges != graph.E, device=device)[..., None])
        for edges, cols in graph.layers
    ]
    syndrome = [torch.as_tensor(cols, device=device) for _, cols in graph.check_buckets]
    return layers, syndrome


def layered_decode(graph, llr, max_iterations, storage=torch.bfloat16):
    """Layered min-sum of (B, n) LLRs on ``graph`` (``graph.build_graph``)."""
    layers, syndrome = _device_tables(graph, llr.device)
    big = float(torch.finfo(storage).max)

    def decode(x):
        B = x.shape[0]
        qv = torch.zeros((graph.n + 1, B), dtype=torch.float32, device=x.device)
        qv[: graph.n] = x.T
        rcv = [torch.zeros((*cols.shape, B), dtype=_container(storage), device=x.device)
               for cols, _ in layers]
        hard = qv <= 0
        hard[graph.n] = False
        stop = _Stop(hard, syndrome, max_iterations)
        while stop.running():
            for (cols, valid), r in zip(layers, rcv):
                rold = r.float()
                inputs = torch.where(valid, qv[cols] - rold, big)
                rnew = _check(inputs, valid, big)
                delta = rnew - rold
                r.copy_(_stored(rnew, storage))
                for t in range(cols.shape[1]):
                    qv[cols[:, t]] += delta[:, t]
            hard = qv <= 0
            hard[graph.n] = False
            stop.test(hard)
        return stop.answer(graph.n)

    return _blocks(decode, llr, LAYERED_BLOCK)


def flooding_decode(graph, llr, max_iterations, storage=torch.bfloat16):
    """Flooding min-sum of (B, n) LLRs on ``graph`` (``graph.build_graph``)."""
    dev = llr.device
    checks = [
        (torch.as_tensor(edges, device=dev), torch.as_tensor(edges != graph.E, device=dev)[..., None])
        for edges, _ in graph.check_buckets
    ]
    variables = [
        (torch.as_tensor(cols, device=dev), torch.as_tensor(edges, device=dev))
        for cols, edges in graph.var_buckets
    ]
    syndrome = [torch.as_tensor(cols, device=dev) for _, cols in graph.check_buckets]
    cols_of_edge = torch.as_tensor(graph.cols, device=dev)
    big = float(torch.finfo(storage).max)

    def decode(x):
        B = x.shape[0]
        kind = _container(storage)
        q = torch.zeros((graph.n + 1, B), dtype=kind, device=dev)
        q[: graph.n] = _stored(x.T, storage)
        v2c = torch.full((graph.E + 1, B), big, dtype=kind, device=dev)
        v2c[: graph.E] = q[cols_of_edge]
        c2v = torch.zeros((graph.E + 1, B), dtype=kind, device=dev)
        hard = q <= 0
        hard[graph.n] = False
        stop = _Stop(hard, syndrome, max_iterations)
        while stop.running():
            # a lane with no edge writes its 0 to message E, which stays 0
            for edges, valid in checks:
                c2v[edges] = _stored(_check(v2c[edges].float(), valid, big), storage)
            hard = torch.zeros((graph.n + 1, B), dtype=torch.bool, device=dev)
            for cols, edges in variables:
                ins = c2v[edges].float()  # (V, d, B)
                tot = q[cols].float()
                for t in range(edges.shape[1]):
                    tot = tot + ins[:, t]
                hard[cols] = tot <= 0
                v2c[edges] = _stored(tot[:, None] - ins, storage)
            v2c[graph.E] = big
            stop.test(hard)
        return stop.answer(graph.n)

    return _blocks(decode, llr, FLOODING_BLOCK)
