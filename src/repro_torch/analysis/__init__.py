"""Analysis helpers of the port: the roofline terms and the card's published
limits (:mod:`repro_torch.analysis.roofline`)."""
