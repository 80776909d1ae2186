"""Vectorized Karel VM on the device, as an eager PyTorch loop.

Port of demo2program_tpu/ops/vm.py (a jnp `lax.while_loop` there, not a
Pallas kernel, so no hand kernel here yet). It runs B compiled programs
(dsl/karel_bytecode.py) against B initial states in lock step and compares
each rollout online with its target demo. Semantics (actions, error modes,
call budget) bit-match the host interpreter dsl/karel_interp.py.

Execution-accuracy contract (`model_full.py:892-916`): a rollout is correct
iff the program halts within budget without environment errors AND its
state-history length equals the demo length AND every state matches.

The loop asks the device whether any machine still runs only every
`CHECK_EVERY` steps (one device->host sync each), not after every step as
the JAX `cond_fn` does. A step after every machine stopped changes nothing,
so this is exact; the last block is cut so the step count never exceeds
max_steps.

Counters (utils/spans.py, kept only while tracing is on): `vm.steps`, the
lock-step iterations of a call; `vm.machine_steps`, B x those; and
`vm.live_machine_steps`, the machines still running at each iteration,
summed on the device and left there until the counters are read.
"""

import numpy as np
import torch

from demo2program_tpu_torch.dsl.karel_bytecode import (
    OP_HALT, OP_BUDGET, OP_INC, OP_ACT, OP_EVAL, OP_NEGC, OP_JMP, OP_JMPF,
    OP_PUSHCTR, OP_JZDEC, MAX_LOOP_DEPTH)
from demo2program_tpu_torch.dsl.karel_interp import MAX_FUNC_CALL
from demo2program_tpu_torch.utils import spans

_FRONT = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int64)
_LEFT = np.array([[0, -1], [-1, 0], [0, 1], [1, 0]], dtype=np.int64)
_RIGHT = np.array([[0, 1], [1, 0], [0, -1], [-1, 0]], dtype=np.int64)

MAX_MARKER_CAP = 9  # reference karel.py:174 quirk: put fails at >9
CHECK_EVERY = 32


def _gather(a, idx):
    """a (B, N), idx (B,) in range -> (B,)."""
    return a.gather(1, idx[:, None])[:, 0]


class _Machines:
    """The state of B machines and the one-step transition."""

    def __init__(self, code, wall, y0, x0, d0, markers0, demo_y, demo_x,
                 demo_d, demo_markers, demo_len, make_error, h, w):
        B, L, _ = code.shape
        T = demo_y.shape[1]
        dev = code.device
        self.h, self.w, self.T, self.L = h, w, T, L
        self.make_error = make_error
        self.op_table = code[:, :, 0].long()
        self.arg_table = code[:, :, 1].long()
        self.wall_f = wall.reshape(B, h * w).bool()
        self.demo_y = demo_y.long()
        self.demo_x = demo_x.long()
        self.demo_d = demo_d.long()
        self.demo_markers = demo_markers.reshape(B, T, h * w).long()
        self.demo_len = demo_len.long()
        self.bidx = torch.arange(B, device=dev)
        self.tabs = {name: (t[:, 0], t[:, 1]) for name, t in (
            ("front", torch.as_tensor(_FRONT, device=dev)),
            ("left", torch.as_tensor(_LEFT, device=dev)),
            ("right", torch.as_tensor(_RIGHT, device=dev)))}

        def zeros(dtype=torch.long):
            return torch.zeros(B, dtype=dtype, device=dev)

        self.pc, self.n, self.sp = zeros(), zeros(), zeros()
        self.cflag = zeros(torch.bool)
        self.fail = zeros(torch.bool)
        self.halt = zeros(torch.bool)
        self.y, self.x, self.d = y0.long(), x0.long(), d0.long()
        self.markers = markers0.reshape(B, h * w).long()
        self.t = torch.ones(B, dtype=torch.long, device=dev)
        self.match = torch.ones(B, dtype=torch.bool, device=dev)
        self.ctr = torch.zeros(B, MAX_LOOP_DEPTH, dtype=torch.long,
                               device=dev)
        # per machine, the steps it was running at (kept while tracing)
        self.live = zeros() if spans.enabled() else None

    def running(self):
        return ~(self.fail | self.halt)

    def _clear_at(self, which):
        dy_tab, dx_tab = self.tabs[which]
        h, w = self.h, self.w
        ny = self.y + dy_tab[self.d]
        nx = self.x + dx_tab[self.d]
        inb = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        nyc = ny.clamp(0, h - 1)
        nxc = nx.clamp(0, w - 1)
        blocked = _gather(self.wall_f, nyc * w + nxc)
        return inb & ~blocked, nyc, nxc

    def step(self):
        active = self.running()
        if self.live is not None:
            self.live += active
        pc = self.pc.clamp(0, self.L - 1)
        op = _gather(self.op_table, pc)
        arg = _gather(self.arg_table, pc)

        # ---- budget ----
        n_new = self.n + torch.where((op == OP_BUDGET) | (op == OP_INC),
                                     arg, 0)
        fail_budget = (op == OP_BUDGET) & (n_new > MAX_FUNC_CALL)

        # ---- percepts ----
        front_ok, fy, fx = self._clear_at("front")
        left_ok, _, _ = self._clear_at("left")
        right_ok, _, _ = self._clear_at("right")
        cell = self.y * self.w + self.x
        here = _gather(self.markers, cell)
        present = here > 0
        pv = torch.where(arg == 0, front_ok, torch.where(
            arg == 1, left_ok, torch.where(
                arg == 2, right_ok, torch.where(arg == 3, present,
                                                ~present))))
        cflag = torch.where(op == OP_EVAL, pv, torch.where(
            op == OP_NEGC, ~self.cflag, self.cflag))

        # ---- actions ----
        is_act = op == OP_ACT
        a_move = is_act & (arg == 0)
        a_turn = is_act & ((arg == 1) | (arg == 2))
        a_pick = is_act & (arg == 3)
        a_put = is_act & (arg == 4)
        move_err = a_move & ~front_ok
        act_err = (move_err | (a_pick & (here <= 0))
                   | (a_put & (here >= MAX_MARKER_CAP)))
        if self.make_error:
            fail_act = act_err
            recorded = is_act & ~act_err
        else:
            fail_act = torch.zeros_like(act_err)
            recorded = is_act  # failed moves turn 180 and are recorded

        do_move = a_move & front_ok
        y_new = torch.where(do_move, fy, self.y)
        x_new = torch.where(do_move, fx, self.x)
        # turns: left d-1, right d+1; `%` is floor-mod, as in jnp
        d_new = torch.where(
            a_turn, (self.d + torch.where(arg == 1, -1, 1)) % 4, self.d)
        if not self.make_error:
            d_new = torch.where(move_err, (self.d + 2) % 4, d_new)
        delta = torch.where(a_pick & (here > 0), -1, torch.where(
            a_put & (here < MAX_MARKER_CAP), 1, 0))
        markers_new = self.markers.scatter_add(
            1, cell[:, None], torch.where(recorded, delta, 0)[:, None])

        # ---- record + online compare ----
        tc = self.t.clamp(0, self.T - 1)
        same_pose = ((y_new == _gather(self.demo_y, tc))
                     & (x_new == _gather(self.demo_x, tc))
                     & (d_new == _gather(self.demo_d, tc)))
        target = self.demo_markers[self.bidx, tc]
        same_markers = (markers_new == target).all(dim=1)
        step_match = torch.where(
            recorded, (self.t < self.demo_len) & same_pose & same_markers,
            True)
        t_new = self.t + recorded.long()

        # ---- control flow ----
        sp_top = (self.sp - 1).clamp(0, MAX_LOOP_DEPTH - 1)
        top = _gather(self.ctr, sp_top)
        is_push = op == OP_PUSHCTR
        is_jz = op == OP_JZDEC
        jz_exit = is_jz & (top == 0)
        pc_new = self.pc + 1
        pc_new = torch.where(op == OP_JMP, arg, pc_new)
        pc_new = torch.where((op == OP_JMPF) & ~cflag, arg, pc_new)
        pc_new = torch.where(jz_exit, arg, pc_new)

        sp_push = self.sp.clamp(0, MAX_LOOP_DEPTH - 1)
        ctr_new = self.ctr.clone()
        ctr_new[self.bidx, sp_push] = torch.where(
            is_push, arg, ctr_new[self.bidx, sp_push])
        ctr_new[self.bidx, sp_top] += torch.where(is_jz & ~jz_exit, -1, 0)
        sp_new = self.sp + torch.where(is_push, 1, torch.where(jz_exit, -1,
                                                               0))

        fail_now = active & (fail_budget | fail_act)
        halt_now = active & (op == OP_HALT)
        live = active & ~fail_now

        def upd(old, new):
            return torch.where(live, new, old)

        self.pc = upd(self.pc, pc_new)
        self.n = torch.where(active, n_new, self.n)
        self.cflag = upd(self.cflag, cflag)
        self.fail = self.fail | fail_now
        self.halt = self.halt | (halt_now & ~fail_now)
        self.y = upd(self.y, y_new)
        self.x = upd(self.x, x_new)
        self.d = upd(self.d, d_new)
        self.markers = torch.where(live[:, None], markers_new, self.markers)
        self.t = upd(self.t, t_new)
        self.match = self.match & torch.where(live, step_match, True)
        self.ctr = torch.where(live[:, None], ctr_new, self.ctr)
        self.sp = upd(self.sp, sp_new)


def run_and_compare(code, wall, y0, x0, d0, markers0,
                    demo_y, demo_x, demo_d, demo_markers, demo_len,
                    *, make_error=True, h=8, w=8, max_steps=None):
    """Run B programs and compare their rollouts with B target demos.

    code (B, L, 2) int bytecode; wall (B, h, w); y0/x0/d0 (B,);
    markers0 (B, h, w); demo_y/x/d (B, T); demo_markers (B, T, h, w);
    demo_len (B,) target state-history lengths (incl. the initial state).
    All on one device.

    Returns dict: correct, success (B,) bool; exe_len, n (B,) int32."""
    L = code.shape[1]
    if max_steps is None:
        max_steps = (MAX_FUNC_CALL + 2) * L
    m = _Machines(code, wall, y0, x0, d0, markers0, demo_y, demo_x, demo_d,
                  demo_markers, demo_len, make_error, h, w)
    steps = 0
    while steps < max_steps and bool(m.running().any()):
        for _ in range(min(CHECK_EVERY, max_steps - steps)):
            m.step()
            steps += 1
    if m.live is not None:
        spans.count("vm.steps", steps)
        spans.count("vm.machine_steps", steps * code.shape[0])
        spans.count("vm.live_machine_steps", m.live.sum())
    success = m.halt & ~m.fail
    correct = success & m.match & (m.t == m.demo_len)
    return {"correct": correct, "success": success, "exe_len": m.t.int(),
            "n": m.n.int()}
