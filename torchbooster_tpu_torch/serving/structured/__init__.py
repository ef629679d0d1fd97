"""Structured generation: schema/regex-constrained decoding — the port
of ``torchbooster_tpu/serving/structured`` (pure Python and numpy, a
near-verbatim copy).

``compiler`` turns a ``response_format`` spec into a token-level DFA
once per schema (fingerprint-cached); ``state`` keeps one automaton
cursor per slot and fuses them into the fixed-shape legality mask the
engine uploads into one device buffer each step — one step shape,
exact token parity for unconstrained traffic, and full composition
with speculative decoding and parallel sampling.
"""
from torchbooster_tpu_torch.serving.structured.compiler import (
    JSON_OBJECT_PATTERN,
    RESPONSE_FORMAT_TYPES,
    SCHEMA_LIBRARY,
    CharDFA,
    TokenDFA,
    bytes_vocab,
    compile_regex,
    compile_response_format,
    conforms,
    library_response_format,
    regex_escape,
    response_format_fingerprint,
    response_format_regex,
    schema_budget,
    schema_to_regex,
    token_dfa,
    validate_response_format,
)
from torchbooster_tpu_torch.serving.structured.state import SlotCursors

__all__ = [
    "CharDFA", "TokenDFA", "SlotCursors", "JSON_OBJECT_PATTERN",
    "RESPONSE_FORMAT_TYPES", "SCHEMA_LIBRARY", "bytes_vocab",
    "compile_regex", "compile_response_format", "conforms",
    "library_response_format", "regex_escape",
    "response_format_fingerprint", "response_format_regex",
    "schema_budget", "schema_to_regex", "token_dfa",
    "validate_response_format",
]
