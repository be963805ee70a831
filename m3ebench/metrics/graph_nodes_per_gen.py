"""CUDA graph nodes the generation loops replayed per generation (each
graph's count from the CUDA driver): the GA loop's device ops a
generation, counted without the profiler."""
from m3ebench.counters import ratio


def read(ctx):
    return ratio("repro_loop_graph_nodes_total",
                 "repro_loop_generations_total")
