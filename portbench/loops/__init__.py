"""The loops that traffic mixes drive, one module each, named by a mix's
``loop``."""
