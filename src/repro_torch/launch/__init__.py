"""Launchers of the port: the production mesh (``mesh``), shape specs
(``specs``), the multi-pod dry run (``dryrun``) and the train and
serve entry points."""
