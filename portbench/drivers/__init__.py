"""Drivers of the program, one a kind of work; a traffic file names one."""
