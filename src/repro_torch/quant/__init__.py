"""Quantized vector representations for the two-stage distance path
(``SearchSpec.estimate="sq8"|"both"``): the SQ8 table codes and the
conservative distance lower bound (``sq8``)."""
