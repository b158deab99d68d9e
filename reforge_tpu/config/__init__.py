"""Pipeline-config DSL: lexer, parser, and semantic pass.

JAX re-implementation of the reference's config layer
(reference: src/config/ — grammar src/config/config_grammar.lalrpop,
semantics src/config/config.rs).
"""

from .ast import GraphExpr, GraphMember, ParamValue, PipelineDecl
from .parser import ConfigParseError, parse_exprs
from .semantics import (
    FILE_INPUT,
    FINAL_OUTPUT,
    Config,
    ConfigDescriptor,
    GraphPipeline,
    PipelineInstance,
    add_file_paths,
    parse,
    parse_file,
    single_shader_parse,
)

__all__ = [
    "GraphExpr",
    "GraphMember",
    "ParamValue",
    "PipelineDecl",
    "ConfigParseError",
    "parse_exprs",
    "FILE_INPUT",
    "FINAL_OUTPUT",
    "Config",
    "ConfigDescriptor",
    "GraphPipeline",
    "PipelineInstance",
    "add_file_paths",
    "parse",
    "parse_file",
    "single_shader_parse",
]
