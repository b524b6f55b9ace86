"""Core helpers of the torch port: trace event ids and sampling."""
