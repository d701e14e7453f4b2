"""Smoke run of the single-point pipeline on one NVIDIA GPU.

Drives the CLI's main path (integrals -> orthogonalisation -> guess -> SCF ->
AO->MO transform -> CC -> (T)) through `tuna_tpu.cli.run`, checks each
energy against a value the project records, then compares the card's
two-electron tensor and one CCSD residual element by element with the same
code on the host CPU.  The last line of stdout is one JSON object naming the
device; any failed comparison or exception exits non-zero without it.

Usage:
    python chip_smoke.py          # one card
    python chip_smoke.py --four   # only the multi-card phase, four cards

There is no CPU fallback: on any platform other than "gpu" the script exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# Recorded energies (Hartree), N2 at 1.1 Angstrom, TIGHTSCF.
# HF/cc-pVTZ: this framework's energy, pinned against the reference TUNA
# implementation at the same settings (README, f-shell parity table).
E_HF_CCPVTZ = -108.9830065320576
# CCSD/cc-pVTZ (o = 7, v = 53): the reference TUNA implementation's energy
# from the project's CCSD benchmark record.
E_CCSD_CCPVTZ = -109.3809436502
# CCSD[T]/6-311G: this framework's energy, pinned against the reference TUNA
# implementation (README, parity table).
E_CCSD_T_6311G = -109.179313514331

ENERGY_TOL_HA = 1e-8          # the project's parity contract
ERI_TOL_ABS = 1e-12           # card vs host ERI, f64
RESIDUAL_TOL_REL = 1e-12      # card vs host CCSD residual, f64
TP_TOL_HA = 1e-9              # sharded vs serial SCF energy

MAIN_PATH = (
    ("hf_ccpvtz_cold", "SPE : N N 1.1 : HF CC-PVTZ : TIGHTSCF", E_HF_CCPVTZ),
    ("hf_ccpvtz_warm", "SPE : N N 1.1 : HF CC-PVTZ : TIGHTSCF", E_HF_CCPVTZ),
    ("hf_ccpvtz_direct", "SPE : N N 1.1 : HF CC-PVTZ : DIRECT TIGHTSCF",
     E_HF_CCPVTZ),
    ("ccsd_ccpvtz", "SPE : N N 1.1 : CCSD CC-PVTZ : TIGHTSCF", E_CCSD_CCPVTZ),
    ("ccsd_t_6311g", "SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF",
     E_CCSD_T_6311G),
)

STAGES = (
    ("integrals_1e", "One-electron integrals"),
    ("integrals_2e", "Two-electron integrals"),
    ("orthogonalisation", "Fock orthogonalisation matrix"),
    ("guess", "Initial guess"),
    ("scf", "Self-consistent field"),
    ("transform", "Molecular orbital transformation"),
    ("cc", "Coupled cluster"),
    ("triples", "Perturbative correction"),
)


class SmokeFailure(RuntimeError):
    """A comparison of the smoke run failed."""


def report(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got: float, want: float, tol: float) -> float:
    """Raise SmokeFailure unless |got - want| <= tol (NaN never passes)."""
    delta = abs(float(got) - float(want))
    if not delta <= tol:
        raise SmokeFailure(f"{name}: {got!r} vs {want!r}, |delta| = "
                           f"{delta:.3e} > {tol:.1e}")
    return delta


def card_name_and_power_limit() -> str:
    """`nvidia-smi` name and power limit of every visible card, one per line,
    read in a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def run_cli(line: str):
    """One CLI calculation; returns (result, wall seconds, stage times).
    For an SPE line result[2] is the energy; for a SCAN line result is
    (bond lengths, energies, dipoles)."""
    from tuna_tpu import cli
    from tuna_tpu.output import reset_timers, timer_table

    reset_timers()
    t0 = time.perf_counter()
    result = cli.run(line, suppress_output=True)
    wall = time.perf_counter() - t0
    return result, wall, dict(timer_table())


def main_path_phase() -> None:
    for name, line, want in MAIN_PATH:
        result, wall, stages = run_cli(line)
        energy = float(result[2])
        delta = check_close(name, energy, want, ENERGY_TOL_HA)
        times = " ".join(f"{key}={stages[label]:.3f}s"
                         for key, label in STAGES if label in stages)
        report(f"[main] {name}: E={energy:.10f} |dE|={delta:.2e} "
               f"wall={wall:.3f}s {times}")


def eri_block_report(basis: str = "CC-PVTZ") -> None:
    """Block edge and compiled memory of the stored-ERI step for N2."""
    import jax
    import jax.numpy as jnp
    from tuna_tpu.drivers import common

    molecule = _molecule(("N", "N"), 1.1, basis)
    plan = common.get_integral_plan(molecule)
    coords = jnp.asarray(molecule.coordinates)
    mem = jax.jit(plan._eri_impl).lower(coords).compile().memory_analysis()
    report(f"[eri] N2/{basis} lmax={plan.lmax} block_edge={plan.eri_row_chunk}"
           f" block_pairs={plan.n_block_pairs} temp_bytes="
           f"{mem.temp_size_in_bytes} output_bytes={mem.output_size_in_bytes}")


def _molecule(symbols, bond_angstrom, basis):
    import numpy as np
    from tuna_tpu import constants
    from tuna_tpu.config import Config
    from tuna_tpu.methods import lookup_method
    from tuna_tpu.system import Molecule

    cfg = Config("SPE", lookup_method("HF"), 0.0, [], basis, list(symbols),
                 suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0],
                       [0.0, 0.0, constants.angstrom_to_bohr(bond_angstrom)]])
    return Molecule(list(symbols), coords, cfg)


def eri_parity_phase(basis: str = "CC-PVQZ") -> None:
    """H2 (f shells on H at cc-pVQZ): card ERI tensor vs the host CPU's."""
    import jax
    import numpy as np
    from tuna_tpu.ops.integrals import IntegralPlan

    molecule = _molecule(("H", "H"), 0.74, basis)
    coords = np.asarray(molecule.coordinates)
    bfs = molecule.cartesian_basis_functions
    plan = IntegralPlan(bfs, molecule.n_atoms)
    card = np.asarray(plan.eri(coords))
    with jax.default_device(jax.devices("cpu")[0]):
        host = np.asarray(IntegralPlan(bfs, molecule.n_atoms).eri(coords))
    err = float(np.max(np.abs(card - host)))
    if not err <= ERI_TOL_ABS:
        raise SmokeFailure(f"ERI parity H2/{basis}: max abs {err:.3e} > "
                           f"{ERI_TOL_ABS:.0e}")
    report(f"[parity] ERI H2/{basis} lmax={plan.lmax} shape={card.shape} "
           f"max_abs={err:.3e}")


def residual_parity_phase(basis: str = "CC-PVTZ") -> None:
    """One restricted CCSD residual for N2: card vs host CPU."""
    import jax
    import numpy as np
    from bench import _setup_ours
    from tuna_tpu.post import cc

    _, _, g, F, d1, d2, t1, t2, o, _ = _setup_ours(
        f"SPE : N N 1.1 : CCSD {basis} : TIGHTSCF")
    no = o.stop - (o.start or 0)
    operands = [np.asarray(x) for x in (g, F, d1, d2, t1, t2)]
    update = cc._RESTRICTED_UPDATES["CCSD"]

    def residual(g, F, d1, d2, t1, t2):
        oo, vv = slice(0, no), slice(no, None)
        B = cc._restricted_blocks(g, oo, vv)
        return update(B, F[oo, vv], d1, d2, t1, t2, {})

    card = [np.asarray(x) for x in jax.jit(residual)(*operands)]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        host = [np.asarray(x) for x in jax.jit(residual)(
            *[jax.device_put(x, cpu) for x in operands])]
    for label, a, b in zip(("t1", "t2"), card, host):
        rel = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        if not rel <= RESIDUAL_TOL_REL:
            raise SmokeFailure(f"CCSD residual {label} parity N2/{basis}: "
                               f"rel {rel:.3e} > {RESIDUAL_TOL_REL:.0e}")
        report(f"[parity] CCSD residual {label} N2/{basis} shape={a.shape} "
               f"max_rel={rel:.3e}")


def four_card_phase(basis: str = "CC-PVTZ", n_points: int = 4) -> None:
    """The multi-device paths that auto-route when several devices are
    visible, each against its one-device counterpart:
      * a data-parallel MP2 SCAN vs one SPE per geometry;
      * a stored-ERI HF SCF on the tensor-parallel Fock build (per-device
        budget forced low) vs the serial SCF;
      * the tensor-parallel MO transform, whose n_mo^4 result must be
        sharded over every device, vs the serial transform.
    """
    import jax
    import numpy as np
    from tuna_tpu import constants, parallel
    from tuna_tpu.cli import parse_input, process_method
    from tuna_tpu.config import Config
    from tuna_tpu.drivers.energy import calculate_energy
    from tuna_tpu.post import transforms

    n_dev = len(jax.devices())
    if n_dev < 2:
        raise SmokeFailure(f"multi-device phase needs >1 device, has {n_dev}")
    report(f"[four] devices={n_dev} kind={jax.devices()[0].device_kind}")

    (bonds, energies, _), wall, _ = run_cli(
        f"SCAN : N N 1.0 : MP2 {basis} : NUM {n_points} STEP 0.05 TIGHTSCF")
    report(f"[four] dp scan of {len(energies)} points: {wall:.3f}s")
    if len(energies) != n_points:
        raise SmokeFailure(f"scan returned {len(energies)} points")
    for bond, energy in zip(bonds, energies):
        r = constants.bohr_to_angstrom(bond)
        result, _, _ = run_cli(f"SPE : N N {r:.10f} : MP2 {basis} : "
                               "TIGHTSCF")
        single = float(result[2])
        delta = check_close(f"scan point {r:.3f}", energy, single,
                            ENERGY_TOL_HA)
        report(f"[four] scan R={r:.3f} E={energy:.10f} single-card "
               f"E={single:.10f} |dE|={delta:.2e}")

    budget = parallel._HBM_BUDGET_ENV
    hf = f"SPE : N N 1.1 : HF {basis} : TIGHTSCF"
    os.environ[budget] = "1000"
    try:
        if parallel.auto_tp_mesh(1e6) is None:
            raise SmokeFailure("tensor-parallel router did not engage")
        tp, wall_tp, _ = run_cli(hf)
    finally:
        del os.environ[budget]
    serial, wall_serial, _ = run_cli(hf)
    e_tp, e_serial = float(tp[2]), float(serial[2])
    delta = check_close("tp fock build", e_tp, e_serial, TP_TOL_HA)
    report(f"[four] tp fock HF/{basis}: E={e_tp:.10f} ({wall_tp:.3f}s) "
           f"serial E={e_serial:.10f} ({wall_serial:.3f}s) |dE|={delta:.2e}")

    ct, ms, b, symbols, coords, params = parse_input(
        f"SPE : N N 1.1 : MP2 {basis} : DIRECT TIGHTSCF")
    cfg = Config(ct, process_method(ms), time.time(), params, b, symbols,
                 suppress_output=True)
    scf, molecule, _, _ = calculate_energy(cfg, symbols, coords, silent=True,
                                           do_correlation=False)
    os.environ[budget] = "1000"
    try:
        g_tp = transforms.transform_direct_mo_chemists(molecule, scf, cfg)
        jax.block_until_ready(g_tp)
    finally:
        del os.environ[budget]
    g_serial = np.asarray(
        transforms.transform_direct_mo_chemists(molecule, scf, cfg))
    n_mo = g_serial.shape[0]
    shards = g_tp.addressable_shards
    devices = {s.device for s in shards}
    rows = sorted(s.data.shape[0] for s in shards)
    if n_mo % n_dev == 0 and (g_tp.sharding.is_fully_replicated
                              or len(devices) != n_dev
                              or rows != [n_mo // n_dev] * n_dev):
        raise SmokeFailure(f"tp MO tensor not sharded over the mesh: "
                           f"{g_tp.sharding}, shard rows {rows}")
    err = float(np.max(np.abs(np.asarray(g_tp) - g_serial)))
    check_close("tp MO transform", err, 0.0, 1e-10)
    report(f"[four] tp MO transform {basis}: shape={g_serial.shape} "
           f"shard rows={rows} on {len(devices)} devices max_abs={err:.3e}")


def _require_gpu(n_cards: int):
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found platform {platform!r}",
              file=sys.stderr)
        sys.exit(2)
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        sys.exit(2)
    return devices


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the multi-card phase on four cards")
    args = parser.parse_args(argv)

    # The parity phases compare against the host CPU device, which must be
    # initialised next to the GPU.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    import jax
    import tuna_tpu  # noqa: F401  (f64 + matmul precision + compile cache)

    devices = _require_gpu(4 if args.four else 1)
    report(f"[device] platform={devices[0].platform} "
           f"kind={devices[0].device_kind} count={len(devices)} "
           f"jax={jax.__version__}")
    report(f"[device] precision: x64={jax.config.jax_enable_x64} "
           f"matmul={jax.config.jax_default_matmul_precision} "
           f"cache={jax.config.jax_compilation_cache_dir}")
    report("[card] " + card_name_and_power_limit().replace("\n", " | "))

    t0 = time.perf_counter()
    if args.four:
        four_card_phase()
    else:
        main_path_phase()
        eri_block_report()
        eri_parity_phase()
        residual_parity_phase()
    report(f"[done] {time.perf_counter() - t0:.3f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
