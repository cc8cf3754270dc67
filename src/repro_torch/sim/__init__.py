"""repro_torch.sim — fleet-scale adaptive-splitting simulation engine."""
from repro_torch.sim.engine import (FleetResult, TP_CLIP_MBPS,
                                    emit_period_samples, estimate_fleet,
                                    run_controllers, simulate_fleet,
                                    simulate_fleet_looped, split_metrics)

__all__ = ["FleetResult", "TP_CLIP_MBPS", "emit_period_samples",
           "estimate_fleet", "run_controllers", "simulate_fleet",
           "simulate_fleet_looped", "split_metrics"]
