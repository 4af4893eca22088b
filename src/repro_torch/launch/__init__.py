"""Entry points of the port: the arype/vpe crossover sweep and the int8 scale
calibration (``calibrate``), and LM serving (``serve``)."""
