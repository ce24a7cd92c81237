"""juliagrid_tpu — a steady-state power-system analysis framework on JAX.

A ground-up JAX/XLA implementation with the capability surface of JuliaGrid
(power flow, optimal power flow, state estimation, observability, bad-data
processing) redesigned for an accelerator: batched dense-block linear
algebra with mixed-precision iterative refinement, pure jittable solver
cores, an in-house interior-point optimizer, and scenario/network sharding
over device meshes.

Public surface mirrors the reference exports (reference
/root/reference/src/JuliaGrid.jl:27-109) in snake_case.
"""

from . import config as _config  # noqa: F401  (enables x64 on import)
from .config import config, default_config, set_config
from .templates import default, set_template, template
from .units import units

# power-system data layer
from .system.load import power_system
from .system.model import ac_model, dc_model, drop_zeros, physical_island
from .system.builders import (add_branch, add_bus, add_generator, cost,
                              update_branch, update_bus, update_generator)
from .system.hdf5io import save_power_system

# measurement layer
from .measurement.load import ems, measurement
from .measurement.devices import (add_ammeter, add_pmu, add_varmeter,
                                  add_voltmeter, add_wattmeter,
                                  update_ammeter, update_pmu,
                                  update_varmeter, update_voltmeter,
                                  update_wattmeter)
from .measurement.configuration import (status, status_ammeter, status_pmu,
                                        status_varmeter, status_voltmeter,
                                        status_wattmeter)
from .measurement.hdf5io import save_measurement

# power flow
from .powerflow.ac import (mismatch, newton_raphson, set_initial_point,
                           solve)
from .powerflow.fast_decoupled import (fast_newton_raphson_bx,
                                       fast_newton_raphson_xb)
from .powerflow.gauss_seidel import gauss_seidel
from .powerflow.dc import dc_power_flow
from .powerflow.driver import power_flow
from .powerflow.limits import adjust_angle, reactive_limit
from .powerflow.newton_bbd import newton_raphson_bbd, power_flow_bbd

# optimal power flow
from .opf.acopf import ac_optimal_power_flow
from .opf.dcopf import dc_optimal_power_flow
from .opf import solve_opf

# state estimation
from .estimation.acse import gauss_newton, increment, state_estimation
from .estimation.dcse import dc_state_estimation
from .estimation.pmuse import pmu_state_estimation
from .estimation.lav import (ac_lav_state_estimation,
                             dc_lav_state_estimation,
                             pmu_lav_state_estimation)
from .estimation.baddata import chi_test, residual_test
from .estimation.observability import (island_topological,
                                       island_topological_flow,
                                       pmu_placement, pmu_placement_apply,
                                       restoration_gram)

# postprocessing
from .postprocessing import ac as ac_post
from .postprocessing import dc as dc_post

# reporting
from .report.tables import (print_branch_constraint, print_branch_data,
                            print_branch_summary, print_bus_constraint,
                            print_bus_data, print_bus_summary,
                            print_generator_constraint,
                            print_generator_data, print_generator_summary,
                            print_ammeter_data, print_pmu_data,
                            print_varmeter_data, print_voltmeter_data,
                            print_wattmeter_data)

__version__ = "0.1.0"
