"""The port's protocol benchmark: BASELINE's cluster configurations driven
as ``pbftd`` clusters, on their own verify pools or through the port's
verify service on the card (``bench.harness``)."""
