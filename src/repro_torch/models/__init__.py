"""Model families of the port (inference): ``dlrm``."""
