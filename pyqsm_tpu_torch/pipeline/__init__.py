"""Entry points of the port: the console ``main`` functions (``cli``)."""
