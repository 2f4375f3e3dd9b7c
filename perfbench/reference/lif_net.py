"""The plain reference: the microcircuit's step in plain PyTorch.

One step, in the order NEST's ``iaf_psc_exp`` with a ring of delays runs
it: the arrivals of this step's ring slot and the step's Poisson
background join the currents, the membrane integrates exactly (Rotter &
Diesmann 1999), the neurons over threshold spike and reset (refractory for
2 ms), the slot is emptied, and each spike's ELL row is added into the
ring at its delay.  With pair STDP (NEST's ``stdp_synapse``, Morrison,
Diesmann & Gerstner 2008) on the E->E synapses, a spike then depresses its
outgoing plastic synapses by ``A_minus * w_ref * x_post`` of their
targets, potentiates its incoming ones by ``A_plus * w_ref * x_pre`` of
their sources, clips what it touched to ``[0, w_max]`` (the whole table
after a run's first step), and bumps both traces.

The reference imports nothing of the program.  It takes the benchmark's
own inputs (the ELL tables and per-neuron numbers ``perfbench/netgen.py``
drew) and works out again the propagators, the background's rates and the
STDP coefficients.  It follows the program from a state of the program
(``follow``): the Poisson counts are drawn from a generator in the state's
generator state, on the state's device, so they are the counts the
program's step draws.  ``dtype`` is the precision of the state and the
weights: float32 as the configuration states, or lower for the control.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import pd14


class Reference:
    """The network of a drawn connectome, ready to follow states on
    ``device``.  ``stdp`` is the configuration's rule (its dict) or None."""

    def __init__(self, c, device, dt: float = 0.1, rate_hz: float = None,
                 stdp: dict = None, dtype=torch.float32):
        dev = torch.device(device)
        self.device, self.dtype, self.dt = dev, dtype, float(dt)
        self.n, self.n_exc = int(c.n_total), int(c.n_exc)
        k = int(np.max(c.out_degree)) if self.n else 1
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        self.targets = as_t(c.targets[:, :k])
        self.weights0 = as_t(c.weights[:, :k])
        self.dbins = as_t(c.dbins[:, :k])
        self.pop_of = as_t(c.pop_of).to(torch.int64)
        self.n_pops = len(c.pop_sizes)
        self.d = int(c.d_max_bins)
        rate = pd14.BG_RATE_HZ if rate_hz is None else float(rate_hz)
        self.basis = as_t(np.asarray(c.k_ext, np.float32)
                          * np.float32(rate * self.dt * 1e-3))
        self.i_dc = as_t(np.asarray(c.i_dc, np.float32)).to(dtype)
        self.w_ext = float(c.w_ext)
        self.p = pd14.propagators(self.dt)
        self.stdp = None
        if stdp is not None:
            # the rule's w_ref (87.8 pA at full scale) scales with w_ext,
            # which is 87.8 pA at full scale: so it is w_ext
            w_ref = self.w_ext
            self.stdp = {
                "dep": stdp["lr"] * stdp["A_minus"] * w_ref,
                "pot": stdp["lr"] * stdp["A_plus"] * w_ref,
                "decay_p": float(np.exp(-self.dt / stdp["tau_plus"])),
                "decay_m": float(np.exp(-self.dt / stdp["tau_minus"])),
                "w_max": stdp["w_max_factor"] * w_ref}
            e = self.n_exc
            self.plastic = torch.zeros_like(self.targets, dtype=torch.bool)
            self.plastic[:e] = self.targets[:e] < e
            self._in_view()

    def _in_view(self) -> None:
        """The plastic entries grouped by target: ``in_flat`` their flat
        indices into ``[N, K]``, a target's from ``in_start`` on, and
        ``in_deg`` of them (a stable sort of their targets)."""
        flat = torch.nonzero(self.plastic.view(-1)).flatten()
        tgt = self.targets.view(-1)[flat]
        order = torch.sort(tgt, stable=True).indices
        self.in_flat = flat[order]
        del flat, order
        self.in_deg = torch.bincount(tgt.to(torch.int64), minlength=self.n)
        self.in_start = torch.cumsum(self.in_deg, 0) - self.in_deg

    def change_sq(self, w_end: torch.Tensor, w_start: torch.Tensor
                  ) -> torch.Tensor:
        """Each projection's sum of squared changes from ``w_start`` to
        ``w_end`` (the benchmark's yardstick, on the reference's own
        keys)."""
        from perfbench import check
        if not hasattr(self, "keys"):
            self.keys = check.projection_keys(self.targets, self.pop_of,
                                              self.n_pops)
        return check.change_sq(w_end, w_start.to(self.device), self.keys,
                               self.n_pops)

    def follow(self, start: dict, n_steps: int) -> np.ndarray:
        """Population spike counts ``[n_steps, n_pops]`` of ``n_steps`` steps
        from ``start``: the program's ``V``, ``I_ex``, ``I_in``,
        ``refrac``, ``ring`` ``[D, 2, N+1]``, step ``t`` and
        ``generator_state``, and with STDP its ``weights`` (the live
        table; its first ``N`` rows and ``K`` columns are read),
        ``x_pre`` and ``x_post``.  ``start`` is the start of a run: the
        whole table is clipped after the first step, as the program clips
        it in a run's first plastic update."""
        return self.advance(start, n_steps)[0]

    def advance(self, start: dict, n_steps: int):
        """``follow``'s counts and the state after the steps (in
        ``start``'s keys, the generator's state included)."""
        n, dt_, p = self.n, self.dtype, self.p
        cast = lambda x: x.to(self.device, dt_).clone()
        V, I_ex, I_in = cast(start["V"]), cast(start["I_ex"]), \
            cast(start["I_in"])
        refrac = start["refrac"].to(self.device, torch.int32).clone()
        ring = cast(start["ring"])
        t = int(start["t"])
        gen = torch.Generator(device=self.device)
        gen.set_state(start["generator_state"])
        w = self.weights0.to(dt_)
        x_pre = x_post = None
        if self.stdp is not None:
            k = self.targets.shape[1]
            w = start["weights"][:n, :k].to(self.device, dt_) \
                .clone().contiguous()
            x_pre = start["x_pre"].to(self.device, torch.float32).clone()
            x_post = start["x_post"].to(self.device, torch.float32).clone()
        flat = ring.view(-1)
        cols = ring.shape[2]
        counts = torch.zeros((n_steps, self.n_pops), dtype=torch.int64,
                             device=self.device)
        for j in range(n_steps):
            slot = t % self.d
            ext = torch.poisson(self.basis, generator=gen).to(torch.int32)
            in_ex = ring[slot, 0, :n] + self.w_ext * ext.to(dt_)
            in_in = ring[slot, 1, :n]
            v = (p["E_L"] + (V - p["E_L"]) * p["P22"] + I_ex * p["P21_ex"]
                 + I_in * p["P21_in"] + self.i_dc * p["P20"])
            I_ex = I_ex * p["P11_ex"] + in_ex
            I_in = I_in * p["P11_in"] + in_in
            ref = refrac > 0
            v = torch.where(ref, p["V_reset"], v)
            spk = (v >= p["V_th"]) & ~ref
            V = torch.where(spk, p["V_reset"], v).to(dt_)
            refrac = torch.where(spk, p["ref_steps"],
                                 torch.clamp(refrac - 1, min=0)
                                 ).to(torch.int32)
            ring[slot].zero_()
            ids = torch.nonzero(spk).flatten()
            if ids.numel():
                tg = self.targets[ids].to(torch.int64)
                real = tg < n
                db = self.dbins[ids].to(torch.int64)
                at = (torch.remainder(t + db, self.d) * 2
                      + (ids >= self.n_exc).to(torch.int64)[:, None]
                      ) * cols + tg
                flat.index_add_(0, at[real], w[ids][real])
                counts[j] = torch.bincount(self.pop_of[ids],
                                           minlength=self.n_pops)
            if self.stdp is not None:
                x_pre, x_post = self._stdp(w, ids, spk, x_pre, x_post,
                                           clip_all=j == 0)
            t += 1
        end = {"V": V, "I_ex": I_ex, "I_in": I_in, "refrac": refrac,
               "ring": ring, "t": t, "generator_state": gen.get_state()}
        if self.stdp is not None:
            end.update(weights=w, x_pre=x_pre, x_post=x_post)
        return counts.cpu().numpy(), end

    def _stdp(self, w, ids, spk, x_pre, x_post, clip_all: bool):
        """One pair-STDP update of ``w`` in place for the spikes ``ids``;
        returns the traces after their decay and bump."""
        s, n, e = self.stdp, self.n, self.n_exc
        if ids.numel():
            k = w.shape[1]
            rows = ids[ids < e]
            pl = self.plastic[rows]
            tg = self.targets[rows].clamp(max=n - 1).to(torch.int64)
            wr = w[rows]
            w[rows] = torch.where(pl, wr + -(s["dep"] * x_post[tg]),
                                  wr).to(w.dtype)
            r_out, c_out = torch.nonzero(pl, as_tuple=True)
            out = rows[r_out] * k + c_out
            lens = self.in_deg[ids]
            total = int(lens.sum())
            wf = w.view(-1)
            if total:
                first = torch.cumsum(lens, 0) - lens
                pos = torch.arange(total, device=w.device) + \
                    torch.repeat_interleave(self.in_start[ids] - first, lens,
                                            output_size=total)
                inc = self.in_flat[pos]
                wf[inc] = (wf[inc] + s["pot"] * x_pre[inc // k]).to(w.dtype)
                out = torch.cat([out, inc])
            wf[out] = wf[out].clamp(0.0, s["w_max"])
        if clip_all:
            w[:e] = torch.where(self.plastic[:e], w[:e].clamp(0.0, s["w_max"]),
                                w[:e])
        f = spk.to(torch.float32)
        return x_pre * s["decay_p"] + f, x_post * s["decay_m"] + f
