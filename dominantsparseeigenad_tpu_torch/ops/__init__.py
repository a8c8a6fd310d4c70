"""Operators, kernels and solvers of the port (see the package docstring)."""

from .bell_spmv import bell_spmm, bell_spmv, detect_slot_plan
from .cg import (bicgstab, cg, cg_info, gmres, minres, solve_deflated,
                 solve_deflated_info, solve_general, solve_spd,
                 solve_symmetric)
from .decomp import (eigh_safe, eigh_safe_truncated, svd_safe,
                     svd_safe_truncated)
from .eig import (EigOptions, PowerInfo, dominant_eig, dominant_eig_multi,
                  dominant_eig_pair, dominant_eig_spectrum,
                  spectrum_structure)
from .eigh import (EighMultiOptions, EighOptions, dominant_eigh,
                   dominant_eigh_multi, refine_eigenpair)
from .lanczos import (LanczosInfo, LanczosResult, arnoldi_step, lanczos,
                      lanczos_adaptive, lanczos_eigh, power_iteration)
from .gen import EighGenOptions, dominant_eigh_gen, solve_deflated_pencil
from .interior import InteriorOptions, interior_eigh
from .lobpcg import LobpcgInfo, lobpcg_eigh, lobpcg_eigh_general
from .observables import (energy_curvature, fidelity_susceptibility,
                          value_d1_d2)
from .operators import (ComposedOperator, DeflatedOperator, DenseOperator,
                        LinearOperator, MatrixFreeOperator, ScaledOperator,
                        ShiftedOperator, SumOperator, TransposedOperator,
                        as_operator, hdot, hmatmul, pivot_gauge,
                        resolve_device, tol_floor)
from .precond import block_jacobi_precond, jacobi_precond, operator_diagonal
from .restart import (RestartState, lanczos_restarted, restart_cycle,
                      restart_extract, restart_init)
from .slicing import (SliceInfo, SliceOptions, logdet, spectral_bounds,
                      spectral_density, spectral_slice, trace_function)
from .sparse import (BCOOOperator, BellOperator, COOOperator, CSROperator,
                     random_bell_operator)
from .spectral import spectral_function
from .svd import dominant_svd

__all__ = [
    "BCOOOperator", "BellOperator", "COOOperator", "CSROperator",
    "ComposedOperator", "DeflatedOperator", "DenseOperator", "EigOptions",
    "EighGenOptions", "EighMultiOptions", "EighOptions", "InteriorOptions",
    "LanczosInfo",
    "LanczosResult", "LinearOperator", "LobpcgInfo", "MatrixFreeOperator",
    "PowerInfo", "RestartState", "ScaledOperator", "ShiftedOperator",
    "SliceInfo", "SliceOptions", "SumOperator",
    "TransposedOperator", "arnoldi_step", "as_operator", "bell_spmm",
    "bell_spmv",
    "bicgstab", "block_jacobi_precond", "cg", "cg_info",
    "detect_slot_plan", "dominant_eig", "dominant_eig_multi",
    "dominant_eig_pair", "dominant_eig_spectrum", "dominant_eigh",
    "dominant_eigh_gen", "dominant_eigh_multi", "dominant_svd", "eigh_safe",
    "eigh_safe_truncated", "energy_curvature", "fidelity_susceptibility",
    "gmres", "hdot", "hmatmul", "interior_eigh", "jacobi_precond",
    "lanczos", "lanczos_adaptive", "lanczos_eigh", "lanczos_restarted",
    "lobpcg_eigh", "lobpcg_eigh_general", "logdet", "minres",
    "operator_diagonal", "pivot_gauge", "power_iteration",
    "random_bell_operator", "refine_eigenpair", "resolve_device",
    "restart_cycle", "restart_extract", "restart_init",
    "solve_deflated", "solve_deflated_info", "solve_deflated_pencil",
    "solve_general", "solve_spd",
    "solve_symmetric", "spectral_bounds", "spectral_density",
    "spectral_function", "spectral_slice", "spectrum_structure", "svd_safe",
    "svd_safe_truncated", "tol_floor", "trace_function", "value_d1_d2",
]
