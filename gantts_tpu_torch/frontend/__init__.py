"""The vocoder front end on the host (the port's own copies): WORLD-style
analysis and synthesis, mel-cepstrum transforms and the MLSA filter, with
the C++ engine of cpp/frontend.cpp where it builds and NumPy versions
otherwise."""
