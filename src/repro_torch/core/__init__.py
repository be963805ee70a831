"""M3E + MAGMA — the paper's contribution (Sections IV & V), in PyTorch."""
from repro_torch.core.encoding import (DecodedSchedule, Individual, Population,
                                       decode, decode_to_lists,
                                       random_population)
from repro_torch.core.bw_allocator import (simulate, simulate_decoded,
                                           simulate_numpy, simulate_population,
                                           simulate_tables, throughput)
from repro_torch.core.job_analyzer import (JobAnalyzer, JobAnalysisTable,
                                           table_from_arrays)
from repro_torch.core.fitness import FitnessFn, FitnessParams
from repro_torch.core.magma import MagmaConfig, SearchResult, magma_search
from repro_torch.core.strategies import (SearchStrategy, available,
                                         get_strategy, run_strategy)
from repro_torch.core.m3e import M3E, geomean

__all__ = [
    "DecodedSchedule", "Individual", "Population", "decode",
    "decode_to_lists", "random_population", "simulate", "simulate_decoded",
    "simulate_numpy", "simulate_population", "simulate_tables", "throughput",
    "JobAnalyzer", "JobAnalysisTable", "table_from_arrays", "FitnessFn",
    "FitnessParams", "MagmaConfig", "SearchResult", "magma_search",
    "SearchStrategy", "available", "get_strategy", "run_strategy", "M3E",
    "geomean",
]
