"""Multi-process training of the port (the counterpart of
``mrn_tpu/parallel``): ``multihost`` joins torchrun's process group,
``mesh`` installs the ``data x expert`` mesh and holds the collectives the
learners, BatchNorm and MRN's ensemble call.  Without a process group every
function of ``mesh`` is the identity."""
