"""Data preparation: the DUFO labeller (``process``) and the AV2 extractor
(``extract_av2``)."""
