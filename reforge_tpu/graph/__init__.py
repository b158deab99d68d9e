"""Graph layer: synthesis, scheduling, and fused XLA program compilation.

JAX replacement for the reference's pipeline-graph/resource layer
(reference: src/vulkan/pipeline_graph.rs, src/vulkan/pipeline.rs).
"""

from .builder import BuiltGraph, PipelineNode, build_graph
from .program import GraphProgram, GraphTraceError, make_program

__all__ = [
    "BuiltGraph",
    "PipelineNode",
    "build_graph",
    "GraphProgram",
    "GraphTraceError",
    "make_program",
]
