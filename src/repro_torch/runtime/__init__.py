"""Fault-tolerant training control of the port."""
