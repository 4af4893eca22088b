"""Entry points of the port: int8 scale calibration (``calibrate``) and LM
serving (``serve``)."""
