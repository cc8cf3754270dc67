"""Device profiles + the paper's UE energy model: E_UE = TDP/threads * t."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops_per_s: float  # effective sustained rate
    tdp_w: float  # thermal design power
    threads: int
    fixed_latency_s: float = 0.0  # invocation overhead (RPC, batching)

    def compute_time(self, flops: float) -> float:
        return self.fixed_latency_s + flops / self.flops_per_s

    def energy(self, compute_time_s: float) -> float:
        """Joules for a compute interval (paper Sec. V: TDP/threads * t)."""
        return self.tdp_w / self.threads * compute_time_s


# paper testbed: UE = 2-core 4GB VM behind a 5G dongle; edge = 2xA40 server.
# UE rate calibrated so Fig. 6's jamming pair reproduces simultaneously:
# fixed ~1.66s at ~9 Mbps needs d_ue(pool2) ~0.18s and adaptive ~0.59s needs
# d_ue(deep) ~0.59s => ~52 GFLOP/s effective (2 AVX-512 cores).
UE_VM_2CORE = DeviceProfile("ue-vm-2core", flops_per_s=52e9, tdp_w=28.0,
                            threads=2, fixed_latency_s=0.0)
EDGE_A40X2 = DeviceProfile("edge-2xa40", flops_per_s=8e12, tdp_w=300.0,
                           threads=64, fixed_latency_s=0.004)

