"""Host-side data: the AV2 .h5 loader, synthetic scenes and the host prep."""
