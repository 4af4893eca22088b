"""Entry points of the port: the arype/vpe crossover sweep and the int8 scale
calibration (``calibrate``), LM serving (``serve``) and LM training
(``train``)."""
