"""Context compaction: classifier, safe splitting, summarize/truncate ladder."""

from .base import (
    CONTEXT_LENGTH_PATTERNS,
    ContextCompactionProvider,
    find_safe_split_point,
    is_context_length_error,
    validate_message_structure,
)
from .v1 import (
    SummarizationCompactionProvider,
    TruncationCompactionProvider,
    fit_from_provider,
)

__all__ = [
    "CONTEXT_LENGTH_PATTERNS",
    "ContextCompactionProvider",
    "SummarizationCompactionProvider",
    "TruncationCompactionProvider",
    "find_safe_split_point",
    "fit_from_provider",
    "is_context_length_error",
    "validate_message_structure",
]
