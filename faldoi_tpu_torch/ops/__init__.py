"""Array operations: stencils, normalization, Gaussian, bicubic (K4),
patch gather (K0), Poisson fill."""
