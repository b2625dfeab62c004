"""The paper's own configuration: the volunteer-grid simulation defaults.

Numbers from §1.1 of the paper: ~700,000 active devices, 4M CPU cores,
average 16.5 CPU GigaFLOPS and 11.4 GB RAM, desktop availability ~60%,
85/7/7 Windows/Mac/Linux split; per-project scale like SETI@home /
Einstein@Home (~1 PetaFLOPS each). Simulations scale the population down
while keeping the per-host statistics.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class BoincSimConfig:
    # per-host statistics (§1.1)
    cpu_gflops_mean: float = 16.5
    ram_gb_mean: float = 11.4
    ncpus: int = 6  # ~4M cores / 700k devices
    availability_desktop: float = 0.6
    availability_mobile: float = 0.4
    os_split_windows: float = 0.85
    os_split_mac: float = 0.07
    os_split_linux: float = 0.07
    # replication defaults (§3.4, §4)
    min_quorum: int = 2
    init_ninstances: int = 2
    max_error_instances: int = 3
    max_success_instances: int = 6
    delay_bound_days: float = 14.0
    adaptive_threshold: int = 10
    # server (§5.1)
    job_cache_slots: int = 1024
    # client (§6.2)
    buffer_lo_days: float = 0.1
    buffer_hi_days: float = 0.5
    time_slice_s: float = 3600.0
    rpc_poll_s: float = 600.0


CONFIG = BoincSimConfig()
