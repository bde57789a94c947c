"""Scoping oracle: offline tuner sweeps compiled into a constant-time
lookup service (featurize -> build -> query -> verify)."""
from repro_torch.fleet.oracle.build import (OracleCell, OracleGrid, OracleTable,
                                            build_oracle, canonical_trace)
from repro_torch.fleet.oracle.features import TraceFeatures, featurize
from repro_torch.fleet.oracle.oracle import (OracleAnswer, ScopingOracle,
                                             query_latency_us)
from repro_torch.fleet.oracle.verify import (SpotCheck, VerificationReport,
                                             verify_oracle)

__all__ = [
    "OracleAnswer", "OracleCell", "OracleGrid", "OracleTable",
    "ScopingOracle", "SpotCheck", "TraceFeatures", "VerificationReport",
    "build_oracle", "canonical_trace", "featurize", "query_latency_us",
    "verify_oracle",
]
