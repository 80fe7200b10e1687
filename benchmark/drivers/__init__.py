"""The driving loops of the traffic mixes, one module each, named by a mix's
``driver``."""
