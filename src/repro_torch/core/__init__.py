"""TASTI core: index, propagation, query engine and sessions."""
