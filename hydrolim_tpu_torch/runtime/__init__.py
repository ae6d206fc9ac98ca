"""Host-side runtime pieces of the port: the exact CTMC oracle (C++, built
with g++ at first use) and the exact stationary law of small systems."""
