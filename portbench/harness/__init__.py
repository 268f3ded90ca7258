"""The benchmark's general machinery: the manifest and the files it names,
the set-up of the system under test, the measured window, the traced
slice, the work bound and the verdict. Nothing here belongs to one
configuration, traffic mix or metric; those are files of their own."""
