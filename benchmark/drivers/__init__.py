"""Drivers, one per kind of traffic: a traffic mix's ``driver`` key names
the module here that runs it."""
