"""S3-Select-style queries over JSON needles (``POST /query``)."""

from .json_query import QueryError, parse_query, query_json_lines

__all__ = ["QueryError", "parse_query", "query_json_lines"]
