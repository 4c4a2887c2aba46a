"""Sharding: the placement of the sealed segments over a serve mesh
(``placement``), and the LM stack's sharding rules over a data x model mesh
of ranks (``rules``) with the ambient mesh the model code reads
(``context``).  The port of ``repro/sharding``."""
