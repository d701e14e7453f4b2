"""Headline benchmark: CCSD time-to-converged-energy on N2/6-311G.

Compares this framework (on whatever device JAX finds) against the CPU
reference implementation (TUNA, run in-process via tools.reference_oracle),
per BASELINE.md: <= 1e-8 Ha energy agreement.

Accounting (like-for-like):
  * wall_ours_ms      -- the shipped solve (the f64 while_loop), MP2 guess to
                         converged f64 fixed point, best of 3
  * wall_ref_ms       -- sum of the reference's timed CCSD iterations
  * per_iter_f64_*    -- f64 per-iteration on both sides.  Ours is a
                         two-point difference: the SAME executable run to
                         convergence (n iters) and with zero convergence
                         thresholds (max_iter iters); the slope
                         (wall_long - wall_short) / (n_long - n_short) is the
                         marginal iteration cost, with the fixed per-call
                         dispatch and the post-loop energy evaluations
                         cancelled -- like-for-like with the reference's
                         per-iteration median, which also excludes its
                         setup/teardown.
  * value (headline)  -- wall_ref / wall_ours: time-to-converged speedup

Prints exactly ONE JSON line on stdout, naming the device it ran on;
progress goes to stderr.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

CONFIG = "SPE : N N 1.1 : CCSD 6-311G : TIGHTSCF"


def note(msg):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Ours
# ---------------------------------------------------------------------------

def _setup_ours(config):
    import jax.numpy as jnp
    from tuna_tpu.cli import parse_input, process_method
    from tuna_tpu.config import Config
    from tuna_tpu.drivers.energy import calculate_energy
    from tuna_tpu.post import transforms

    calc_type, method_string, basis, symbols, coordinates, params = parse_input(config)
    cfg = Config(calc_type, process_method(method_string), time.time(), params,
                 basis, symbols, suppress_output=True)
    t0 = time.perf_counter()
    SCF_output, molecule, _, _ = calculate_energy(cfg, symbols, coordinates,
                                                  silent=True, do_correlation=False)
    note(f"SCF pipeline (incl. any compile): {time.perf_counter() - t0:.2f}s")

    g, _, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
        molecule, SCF_output.integrals.ERI_AO, SCF_output, cfg, silent=True)
    g = g.swapaxes(1, 2)
    epsilons = jnp.asarray(epsilons)
    F = jnp.diag(epsilons)
    d1 = transforms.singles_epsilons(epsilons, o, v)
    d2 = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    t1_0, t2_0 = d1 * F[o, v], g[o, o, v, v] * d2
    return cfg, SCF_output, g, F, d1, d2, t1_0, t2_0, o, v


def slope_per_iteration(samples):
    """Marginal cost of one iteration: the smallest two-point slope, or
    None when no run went past the converged iteration count."""
    return min(samples) if samples else None


def measure_ours(config=CONFIG, label="headline"):
    import jax
    import jax.numpy as jnp
    from tuna_tpu.post.cc import CCSettings, get_cc_solver

    cfg, SCF_output, g, F, d1, d2, t1_0, t2_0, o, v = _setup_ours(config)

    settings = CCSettings(
        method="CCSD", restricted=True, update_singles=True,
        keep_disconnected=True, n_occ=o.stop - (o.start or 0),
        n_virt=int(t2_0.shape[-1]), max_iter=cfg.correlated_max_iter,
        use_diis=True, max_diis=cfg.max_DIIS_matrices, damping=0.0)
    # The shipped solve on every backend: the f64 while_loop
    # (post/cc.py calculate_coupled_cluster_energy).
    solver = get_cc_solver(settings)
    dummy, d3 = jnp.zeros((1, 1)), jnp.zeros((1,))

    def solve(t2s, energy_conv, amp_conv):
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            solver(g, F, d1, d2, t1_0, t2s, dummy, dummy, dummy, d3,
                   energy_conv, amp_conv))
        return time.perf_counter() - t0, out

    _, out = solve(t2_0, cfg.energy_convergence, cfg.amp_conv)  # compile
    if not bool(out[1]) or bool(out[2]):
        raise RuntimeError("CCSD solve did not converge")
    E_corr = float(out[3])
    note(f"{label}: solve converged in {int(out[0])} iterations, "
         f"E_corr = {E_corr:.10f}")

    # Wall-to-converged, best of 3
    walls = []
    for i in range(3):
        t2p = jax.block_until_ready(t2_0 * (1 + 1e-10 * (i + 1)))
        wall, out = solve(t2p, cfg.energy_convergence, cfg.amp_conv)
        walls.append(wall)
    wall_ours = min(walls)
    n64 = int(out[0])
    note(f"{label}: wall-to-converged (ours): {wall_ours * 1e3:.1f} ms "
         f"({n64} iterations)")

    # Per-iteration (like-for-like with the reference's iterations):
    # two-point slope over the SAME executable -- convergence thresholds are
    # runtime scalars, so zero thresholds force the full max_iter sweep
    # without recompiling.  The slope cancels the fixed per-call costs
    # (dispatch, post-loop energy evaluations), which the reference's
    # per-iteration median does not pay either.
    solve(t2_0, 0.0, 0.0)
    samples = []
    for i in range(2):
        t2p = jax.block_until_ready(t2_0 * (1 + 1e-10 * (i + 1)))
        w_short, out_short = solve(t2p, cfg.energy_convergence, cfg.amp_conv)
        w_long, out_long = solve(t2p, 0.0, 0.0)
        n_short, n_long = int(out_short[0]), int(out_long[0])
        if n_long > n_short:
            samples.append((w_long - w_short) / (n_long - n_short))
    per_iter_f64 = slope_per_iteration(samples)
    note(f"{label}: per-iteration slope: "
         + (f"{per_iter_f64 * 1e3:.3f} ms" if per_iter_f64 is not None
            else "not measured (no run went past convergence)"))

    E_total = float(SCF_output.energy) + E_corr
    return {"wall_ours": wall_ours, "per_iter_f64_ours": per_iter_f64,
            "n_iter_f64": n64, "E_total": E_total,
            "solver": "f64_while_loop"}


# ---------------------------------------------------------------------------
# Reference (CPU, in-process)
# ---------------------------------------------------------------------------

def measure_reference(config=CONFIG, label="headline", runs=2):
    sys.path.insert(0, ".")
    from tools.reference_oracle import load_reference, reference_calculation

    load_reference()
    import tuna_cc
    import tuna_energy

    best_wall, per_iter, E_ref, n_iter = None, None, None, 0
    original = tuna_cc.run_restricted_CCSD_iteration
    for run in range(runs):
        iteration_times = []

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            result = original(*args, **kwargs)
            iteration_times.append(time.perf_counter() - t0)
            return result

        tuna_cc.run_restricted_CCSD_iteration = timed
        try:
            calculation, symbols, coordinates = reference_calculation(config)
            result = tuna_energy.evaluate_molecular_energy(
                calculation, symbols, coordinates, terse=True, silent=True)
            E_ref = float(result[2])
        finally:
            tuna_cc.run_restricted_CCSD_iteration = original

        wall = sum(iteration_times)
        if best_wall is None or wall < best_wall:
            best_wall = wall
            per_iter = statistics.median(iteration_times)
            n_iter = len(iteration_times)

    note(f"{label}: reference CCSD: {n_iter} iterations, median "
         f"{per_iter * 1e3:.2f} ms/iter, wall {best_wall * 1e3:.1f} ms, "
         f"E = {E_ref:.10f}")
    return {"wall_ref": best_wall, "per_iter_ref": per_iter,
            "n_iter_ref": n_iter, "E_ref": E_ref}


def measure_secondary(basis="CC-PVTZ"):
    """Large-basis CCSD comparison: the FLOP-carrying regime (o=7, v=53);
    the 6-311G headline (o=7, v=19) is latency-bound."""
    if os.environ.get("BENCH_SECONDARY", "1") == "0":
        return None
    config = f"SPE : N N 1.1 : CCSD {basis} : TIGHTSCF"
    note(f"--- secondary metric: {config} ---")
    ours = measure_ours(config, label=basis)
    ref = measure_reference(config, label=basis, runs=1)
    note(f"{basis}: wall speedup {ref['wall_ref'] / ours['wall_ours']:.1f}x, "
         f"energy delta {abs(ours['E_total'] - ref['E_ref']):.2e} Ha")
    return {"wall_speedup_ccpvtz": ref["wall_ref"] / ours["wall_ours"],
            "per_iter_f64_speedup_ccpvtz": _ratio(ref["per_iter_ref"],
                                                  ours["per_iter_f64_ours"]),
            "wall_ours_ms_ccpvtz": ours["wall_ours"] * 1e3,
            "wall_ref_ms_ccpvtz": ref["wall_ref"] * 1e3,
            "energy_delta_ha_ccpvtz": abs(ours["E_total"] - ref["E_ref"])}


def _ratio(num, den):
    return None if den is None else num / den


def _rounded(x, ndigits):
    return None if x is None else round(x, ndigits)


def main():
    # The stdout contract is exactly ONE JSON line.  The reference prints its
    # ASCII banner to stdout on import (reference tuna.py:35), and future code
    # may stray, so ALL measurement work runs with stdout redirected to stderr
    # and the JSON line is written to the real stdout last.
    real_stdout = sys.stdout
    sys.stdout = sys.stderr
    try:
        import jax
        from chip_smoke import card_name_and_power_limit
        device = {"platform": jax.devices()[0].platform,
                  "kind": jax.devices()[0].device_kind,
                  "count": len(jax.devices()),
                  "card": card_name_and_power_limit()}
        note(f"device: {device}")
        ours = measure_ours()
        ref = measure_reference()

        delta = abs(ours["E_total"] - ref["E_ref"])
        note(f"energy delta vs reference: {delta:.2e} Ha "
             f"({'OK' if delta < 1e-8 else 'OUT OF CONTRACT'})")

        speedup_wall = ref["wall_ref"] / ours["wall_ours"]
        speedup_iter = _ratio(ref["per_iter_ref"], ours["per_iter_f64_ours"])

        secondary = None
        try:
            secondary = measure_secondary()
        except Exception as exc:  # secondary must never break the contract
            note(f"secondary metric skipped: {exc!r}")
    finally:
        sys.stdout = real_stdout

    per_iter = ours["per_iter_f64_ours"]
    print(json.dumps({
        "metric": "ccsd_wall_to_converged_speedup_vs_cpu_reference",
        "value": round(speedup_wall, 3),
        "unit": "x",
        "wall_ours_ms": round(ours["wall_ours"] * 1e3, 2),
        "wall_ref_ms": round(ref["wall_ref"] * 1e3, 2),
        "per_iter_f64_ours_ms": _rounded(
            None if per_iter is None else per_iter * 1e3, 3),
        "per_iter_ref_ms": round(ref["per_iter_ref"] * 1e3, 3),
        "speedup_per_iter_f64": _rounded(speedup_iter, 3),
        "solver": ours["solver"],
        "n_iter_f64_ours": ours["n_iter_f64"],
        "n_iter_ref": ref["n_iter_ref"],
        "energy_delta_ha": float(f"{delta:.3e}"),
        "device": device,
        **({k: (None if val is None else float(f"{val:.4g}"))
            for k, val in secondary.items()} if secondary else {}),
    }), flush=True)


if __name__ == "__main__":
    main()
