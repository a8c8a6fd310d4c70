"""Physics models of the port: the TFIM flagship, 1D and 2D, and its
row-sharded form (``models/tfim.py``), the XXZ chain (``models/heisenberg.py``) and the
2D classical Ising TRG/CTMRG flows with their transfer observables
(``models/ising2d.py``)."""

from .heisenberg import (heisenberg_dense, heisenberg_ground_energy,
                         heisenberg_operator)

from .ising2d import (correlation_length, ctmrg_environment,
                      ctmrg_free_energy, ising_observables,
                      ising_vertex_tensor, onsager_free_energy,
                      transfer_operator, transfer_spectral_gap,
                      trg_free_energy, trg_step)
from .tfim import (fidelity_susceptibility, flip_sum, tfim_dense_hamiltonian,
                   tfim_ed_observables, tfim_energy_gap, tfim_exact_chi_f,
                   tfim_exact_d2e0_dg2, tfim_exact_de0_dg, tfim_exact_e0,
                   tfim_ground_energy, tfim_ground_state, tfim_matvec,
                   tfim_observables_sweep, tfim_operator,
                   tfim_sharded_operator, tfim_zz_diagonal,
                   tfim2d_dense_hamiltonian, tfim2d_operator,
                   tfim2d_zz_diagonal)

__all__ = [
    "correlation_length", "ctmrg_environment", "ctmrg_free_energy",
    "ising_observables", "ising_vertex_tensor", "onsager_free_energy",
    "transfer_operator", "transfer_spectral_gap", "trg_free_energy",
    "trg_step",
    "fidelity_susceptibility", "flip_sum", "tfim_dense_hamiltonian",
    "tfim_ed_observables", "tfim_energy_gap", "tfim_exact_chi_f", "tfim_exact_d2e0_dg2",
    "tfim_exact_de0_dg",
    "tfim_exact_e0", "tfim_ground_energy", "tfim_ground_state",
    "tfim_matvec", "tfim_observables_sweep", "tfim_operator",
    "tfim_sharded_operator",
    "tfim_zz_diagonal", "tfim2d_dense_hamiltonian", "tfim2d_operator",
    "tfim2d_zz_diagonal",
    "heisenberg_dense", "heisenberg_ground_energy", "heisenberg_operator",
]
