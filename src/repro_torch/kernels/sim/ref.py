"""Plain PyTorch versions of the two simulator kernels (the tests' oracle).

Eager torch programs of the same functions as the reference's jitted
``lax.scan`` dense cycle loop and ``lax.while_loop`` sparse fixpoint, over
int64 tensors on any device, with the reference's 16-bit masks. They are
what the ``torch`` sim backend runs on the CPU, and what ``chip_smoke.py``
holds ``sim_dense`` and ``sim_sparse`` to on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.sim_vec import MASK, _OPC

#: rounds between two reads of the sparse loop's ``fired`` flag: a round
#: that fires nothing changes no state, so the rounds run past the fixpoint
#: change nothing and only the host syncs are saved
FLAG_EVERY = 16


class SparseResult(NamedTuple):
    """End state of a sparse run: buffer occupancy [n_buf], undelivered
    tokens of each feed row, output tokens [max(1, n_out), max_cycles] (row
    ``o`` valid up to ``ocnt[o]``), output counts [max(1, n_out)], whether
    the last round fired (0-d) and the rounds run, the last non-firing one
    counted (0-d)."""

    blen: torch.Tensor
    frem: torch.Tensor
    outm: torch.Tensor
    ocnt: torch.Tensor
    fired: torch.Tensor
    rounds: torch.Tensor


def _t(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev)


def _apply_op(op: int, a0, a1, a2, rom_rows, table_mat, tab_len):
    """Opcode ``op`` of ``_OPS`` over int64 tensors of values in
    ``[0, 0xFFFF]``: the interpreter's ``PE_OPS`` formula, elementwise."""
    if op == _OPC["zero"]:
        return torch.zeros_like(a0)
    if op == _OPC["pass"]:
        return a0
    if op == _OPC["add"]:
        return (a0 + a1) & MASK
    if op == _OPC["sub"]:
        return (a0 - a1) & MASK
    if op == _OPC["mul"]:
        return (a0 * a1) & MASK
    if op == _OPC["and"]:
        return a0 & a1
    if op == _OPC["or"]:
        return a0 | a1
    if op == _OPC["xor"]:
        return a0 ^ a1
    if op == _OPC["shr"]:
        return (a0 >> (a1 & 0xF)) & MASK
    if op == _OPC["shl"]:
        return (a0 << (a1 & 0xF)) & MASK
    if op == _OPC["min"]:
        return torch.minimum(a0, a1)
    if op == _OPC["max"]:
        return torch.maximum(a0, a1)
    if op == _OPC["abs"]:
        return torch.where(a0 < 0x8000, a0, (-a0) & MASK)
    cmp = {_OPC["gt"]: torch.gt, _OPC["lt"]: torch.lt, _OPC["eq"]: torch.eq,
           _OPC["ne"]: torch.ne, _OPC["ge"]: torch.ge, _OPC["le"]: torch.le}
    if op in cmp:
        return cmp[op](a0, a1).to(a0.dtype)
    if op == _OPC["mux"]:
        return torch.where((a0 & 1) != 0, a1, a2)
    if op in (_OPC["sel"], _OPC["phi"]):
        return torch.where((a2 & 1) != 0, a0, a1)
    if op == _OPC["steer"]:
        return torch.where((a1 & 1) != 0, a0, torch.zeros_like(a0))
    if op == _OPC["rom"]:
        return table_mat[rom_rows, a0 % tab_len[rom_rows]]
    raise ValueError(f"opcode {op} has no dense evaluation")


def sim_dense_plain(prog, in_mat: torch.Tensor, cycles: int) -> torch.Tensor:
    """All ``cycles`` of a ``DenseProgram``: ``in_mat`` [n_in, cycles] ->
    outputs [n_out, cycles], int64 on ``in_mat``'s device.

    The reference's scan step, op for op: the lowering's canonical slot
    layout (inputs, seq heads, accumulators, constants, then each group a
    contiguous range) makes every write a slice, and a ring's pointer at
    cycle ``t`` is ``t % latency``.
    """
    dev = in_mat.device
    n_in, n_seq, n_acc = (len(prog.input_pos), len(prog.seq_pos),
                          len(prog.accum_pos))
    xs = in_mat.to(torch.int64).t().contiguous()            # [cycles, n_in]
    val = torch.zeros(prog.n_nodes + 1, dtype=torch.int64, device=dev)
    val[_t(prog.const_pos, dev)] = _t(prog.const_vals, dev)
    table_mat, tab_len = _t(prog.table_mat, dev), _t(prog.tab_len, dev)

    def groups(gs):
        return [(g.op, int(g.out[0]), len(g.out), _t(g.args, dev),
                 _t(g.rom_rows.clip(min=0), dev)) for g in gs if len(g.out)]

    comb, seqg = groups(prog.comb_groups), groups(prog.seq_groups)
    out_pos = _t(prog.output_pos, dev)
    acc_src, acc_pred = _t(prog.accum_src, dev), _t(prog.accum_pred, dev)
    acc_pmask = _t(prog.accum_pmask, dev)
    seq_state = torch.zeros((max(1, n_seq), prog.max_lat), dtype=torch.int64,
                            device=dev)
    seq_ar = torch.arange(max(1, n_seq), device=dev)
    seq_ptr = (torch.arange(cycles, device=dev)[:, None]
               % _t(prog.seq_lat, dev).clamp(min=1))        # [cycles, n_seq]
    accum = torch.zeros(n_acc, dtype=torch.int64, device=dev)
    outs = torch.zeros((cycles, len(prog.output_pos)), dtype=torch.int64,
                       device=dev)

    def result(op, args, rows):
        a = val[args]
        return _apply_op(op, a[:, 0], a[:, 1], a[:, 2], rows, table_mat,
                        tab_len)

    for t in range(cycles):
        val[:n_in] = xs[t]
        if n_seq:
            val[n_in:n_in + n_seq] = seq_state[seq_ar, seq_ptr[t]]
        if n_acc:
            val[n_in + n_seq:n_in + n_seq + n_acc] = accum
        for op, s0, size, args, rows in comb:
            val[s0:s0 + size] = result(op, args, rows)
        outs[t] = val[out_pos]
        if n_acc:
            en = ~acc_pmask | ((val[acc_pred] & 1) == 1)
            accum = torch.where(en, (accum + val[acc_src]) & MASK, accum)
        if n_seq:
            seq_state[seq_ar, seq_ptr[t]] = torch.cat(
                [result(op, args, rows) for op, _, _, args, rows in seqg])
    return outs.t().contiguous()


def sim_sparse_plain(prog, feed: torch.Tensor, frem: torch.Tensor,
                     max_cycles: int) -> SparseResult:
    """The fire-vector fixpoint of a ``SparseProgram`` to quiescence or
    ``max_cycles`` rounds, int64 on ``feed``'s device."""
    dev = feed.device
    feed, frem = feed.to(torch.int64), frem.to(torch.int64).clone()
    n_buf, n_ev = prog.n_buf, len(prog.ev_names)
    n_in, n_out = len(prog.input_names), len(prog.output_names)
    n_cb = len(prog.const_buf)
    T = {k: _t(getattr(prog, k), dev) for k in (
        "cap", "ev_in", "ev_in_mask", "ev_has_in", "ev_out", "ev_out_mask",
        "ev_op", "ev_rom", "ev_acc", "acc_ev", "in_out", "in_out_mask",
        "const_buf", "const_val", "out_buf", "buf_src_ev", "buf_src_in",
        "buf_cons_ev", "buf_cons_out", "table_mat", "tab_len")}
    cap = T["cap"]
    ev_ops = sorted({int(o) for o in prog.ev_op[:n_ev]})
    ar_buf = torch.arange(n_buf, device=dev)
    ar_in = torch.arange(len(frem), device=dev)
    ar_out = torch.arange(max(1, n_out), device=dev)
    src_ev, src_in = T["buf_src_ev"].clamp(min=0), T["buf_src_in"].clamp(min=0)
    cons_ev, cons_out = (T["buf_cons_ev"].clamp(min=0),
                         T["buf_cons_out"].clamp(min=0))
    acc_idx = T["ev_acc"].clamp(min=0)
    buf = torch.zeros((n_buf, prog.max_cap), dtype=torch.int64, device=dev)
    blen = torch.zeros(n_buf, dtype=torch.int64, device=dev)
    brp = torch.zeros(n_buf, dtype=torch.int64, device=dev)
    fptr = torch.zeros_like(frem)
    accum = torch.zeros(max(1, prog.n_acc), dtype=torch.int64, device=dev)
    outm = torch.zeros((max(1, n_out), max_cycles), dtype=torch.int64,
                       device=dev)
    ocnt = torch.zeros(max(1, n_out), dtype=torch.int64, device=dev)
    fired = torch.ones((), dtype=torch.bool, device=dev)
    live = torch.ones((), dtype=torch.bool, device=dev)
    rounds = torch.zeros((), dtype=torch.int64, device=dev)
    false = torch.zeros(1, dtype=torch.bool, device=dev)

    for r in range(max_cycles):
        heads = buf[ar_buf, brp]
        nonempty, space = blen > 0, blen < cap
        ev_fire = ((nonempty[T["ev_in"]] | ~T["ev_in_mask"]).all(dim=1)
                   & T["ev_has_in"]
                   & (space[T["ev_out"]] | ~T["ev_out_mask"]).all(dim=1))
        out_fire = nonempty[T["out_buf"]] if n_out else false
        in_fire = (frem > 0) & (space[T["in_out"]]
                                | ~T["in_out_mask"]).all(dim=1)
        c_push = blen[T["const_buf"]] == 0
        fired = (ev_fire.any() | out_fire.any() | in_fire.any()
                 | c_push.any())
        rounds = rounds + live.long()
        live = live & fired
        a = torch.where(T["ev_in_mask"], heads[T["ev_in"]], 0)
        a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
        v = torch.zeros_like(a0)
        for op in ev_ops:
            if op == _OPC["acc"]:
                res = (accum[acc_idx] + a0) & MASK
            elif op == _OPC["accp"]:
                held = accum[acc_idx]
                res = torch.where((a1 & 1) == 1, (held + a0) & MASK, held)
            else:
                res = _apply_op(op, a0, a1, a2, T["ev_rom"], T["table_mat"],
                               T["tab_len"])
            v = torch.where(T["ev_op"] == op, res, v)
        if prog.n_acc:
            accum = torch.where(ev_fire[T["acc_ev"]], v[T["acc_ev"]], accum)
        popped = (((T["buf_cons_ev"] >= 0) & ev_fire[cons_ev])
                  | ((T["buf_cons_out"] >= 0) & out_fire[cons_out]))
        if n_out:
            col = ocnt.clamp(max=max_cycles - 1)
            outm[ar_out, col] = torch.where(out_fire, heads[T["out_buf"]],
                                            outm[ar_out, col])
            ocnt = ocnt + out_fire.long()
        blen = blen - popped.long()
        brp = (brp + popped.long()) % cap
        push = (T["buf_src_ev"] >= 0) & ev_fire[src_ev]
        pval = torch.where(push, v[src_ev], 0)
        tok = feed[ar_in, fptr.clamp(max=feed.shape[1] - 1)]
        pin = (T["buf_src_in"] >= 0) & in_fire[src_in]
        push = push | pin
        pval = torch.where(pin, tok[src_in], pval)
        if n_cb:
            cb = T["const_buf"]
            push[cb] = push[cb] | c_push
            pval[cb] = torch.where(c_push, T["const_val"], pval[cb])
        pos = (brp + blen) % cap
        buf[ar_buf, pos] = torch.where(push, pval, buf[ar_buf, pos])
        blen = blen + push.long()
        fptr = fptr + in_fire.long()
        frem = frem - in_fire.long()
        if r % FLAG_EVERY == FLAG_EVERY - 1 and not bool(fired):
            break
    return SparseResult(blen, frem, outm, ocnt, fired.to(torch.int64),
                        rounds)
