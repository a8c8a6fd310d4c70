"""Physics models of the port (see ``models/tfim.py``)."""

from .tfim import (fidelity_susceptibility, flip_sum, tfim_dense_hamiltonian,
                   tfim_ed_observables, tfim_exact_chi_f, tfim_exact_d2e0_dg2,
                   tfim_exact_de0_dg, tfim_exact_e0, tfim_ground_energy, tfim_ground_state,
                   tfim_matvec, tfim_operator, tfim_zz_diagonal)

__all__ = [
    "fidelity_susceptibility", "flip_sum", "tfim_dense_hamiltonian",
    "tfim_ed_observables", "tfim_exact_chi_f", "tfim_exact_d2e0_dg2",
    "tfim_exact_de0_dg",
    "tfim_exact_e0", "tfim_ground_energy", "tfim_ground_state",
    "tfim_matvec", "tfim_operator", "tfim_zz_diagonal",
]
