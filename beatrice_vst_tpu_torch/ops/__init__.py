"""Signal-processing ops of the port: mel front end, resampling, gain and
the pitch transform."""
