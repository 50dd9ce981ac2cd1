"""Model families of the port: ``dlrm`` (inference) and the LM family
(``transformer`` on ``layers``)."""
