"""Runnable end-to-end case studies of the port."""
