"""Plain references of the nets the port runs beside 3PU: each a forward
pass in plain ``torch`` and float32, in a module that imports no kernel
and no other module of the port, for the tests to hold the port to."""
