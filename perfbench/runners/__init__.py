"""One timed loop a kind of traffic (``traffic/<mix>.json`` names it as ``runner``)."""
