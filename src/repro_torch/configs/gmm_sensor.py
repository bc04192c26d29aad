"""The paper's own experiment configuration (Sec. V-A): Bayesian GMM over a
50-node random geometric sensor network."""
from dataclasses import dataclass


@dataclass(frozen=True)
class GMMSensorConfig:
    n_nodes: int = 50
    n_per_node: int = 100
    K: int = 3
    D: int = 2
    comm_radius: float = 0.8
    tau: float = 0.2          # dSVB forgetting rate (Fig. 3 optimum)
    d0: float = 1.0
    rho: float = 0.5          # ADMM penalty (Fig. 7 choice)
    xi: float = 0.05          # kappa ramp (Eq. 40)
    n_iters: int = 2000
    alpha0: float = 1.0
    beta0: float = 0.1
    w0_scale: float = 10.0


CONFIG = GMMSensorConfig()
