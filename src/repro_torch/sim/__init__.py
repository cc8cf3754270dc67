"""repro_torch.sim — fleet-scale adaptive-splitting simulation engine."""
from repro_torch.sim.engine import (FleetResult, TP_CLIP_MBPS,
                                    emit_period_samples, estimate_fleet,
                                    run_controllers, run_scheduled,
                                    simulate_fleet, simulate_fleet_looped,
                                    split_metrics)
from repro_torch.sim.cells import (CellsResult, attach_ring,
                                   build_cells_episode, cell_load,
                                   coupled_interference_mw, handover_grid,
                                   jain_index, ring_coupling, simulate_cells)
from repro_torch.sim.pool import (LifecycleStats, PoolState, pool_init,
                                  pool_programs, simulate_pool)
from repro_torch.sim.sched import (POLICIES, SchedulerConfig,
                                   SchedulerState, cell_shares,
                                   scheduler_init, scheduler_step)

__all__ = ["CellsResult", "FleetResult", "LifecycleStats", "POLICIES",
           "PoolState", "SchedulerConfig", "SchedulerState", "TP_CLIP_MBPS",
           "attach_ring", "build_cells_episode", "cell_load", "cell_shares",
           "coupled_interference_mw", "emit_period_samples",
           "estimate_fleet", "handover_grid", "jain_index", "pool_init",
           "pool_programs", "ring_coupling", "run_controllers",
           "run_scheduled", "scheduler_init", "scheduler_step",
           "simulate_cells", "simulate_fleet", "simulate_fleet_looped",
           "simulate_pool", "split_metrics"]
