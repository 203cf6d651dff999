"""The paper's own workload: Stable Diffusion 2.1 deployment-unit profiles.

The port's copy of the JAX package's ``configs/sd21.py``, on the port's
``DUProfile``.  These are the five DUs of Table 1 / Table 2 of the paper,
verbatim: what ``resolve_serving_arch("sd21")`` returns for the fleet's job
tier.

Table 1 columns: (model, hardware, framework), $/hr, T_i^max (RPS),
cost-of-inference-per-second.  Table 2 adds observed latency L_i (sec) and the
capacity-normalized T^adjusted.
"""
from repro_torch.core.deployment import DUProfile

# (name, cost_per_hour, t_max_rps, latency_s)
_PAPER_TABLE = (
    ("sd21-inf2-neuron", 0.7582, 105.0, 0.67),
    ("sd21-trn1-neuron", 1.3438, 130.0, 0.51),
    ("sd21-g5-triton", 1.0060, 90.0, 0.68),
    ("sd21-g6-triton", 0.8048, 61.0, 0.96),
    ("sd21-g5-cuda", 1.0060, 60.0, 0.92),
)

# Paper Table 1 "Cost of Inference/Second" (recomputed and asserted in tests).
PAPER_COST_PER_INFERENCE = {
    "sd21-inf2-neuron": 0.00733,
    "sd21-trn1-neuron": 0.01023,
    "sd21-g5-triton": 0.01118,
    "sd21-g6-triton": 0.01320,
    "sd21-g5-cuda": 0.01677,
}

# Paper Table 2 "T^adjusted" column.
PAPER_T_ADJUSTED = {
    "sd21-inf2-neuron": 89.2,
    "sd21-trn1-neuron": 89.2,
    "sd21-g5-triton": 89.2,
    "sd21-g6-triton": 61.0,
    "sd21-g5-cuda": 60.0,
}


def paper_deployment_units() -> tuple:
    """The five SD21 DUs exactly as measured by the paper."""
    return tuple(
        DUProfile(
            name=name,
            model="sd21",
            hardware=name.split("-")[1],
            framework=name.split("-")[2],
            cost_per_hour=cph,
            t_max=t_max,
            latency_s=lat,
        )
        for name, cph, t_max, lat in _PAPER_TABLE
    )
