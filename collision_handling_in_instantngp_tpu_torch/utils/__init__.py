"""Profiling and device-memory helpers of the port."""
