"""The mesh trainer: the paper's protocol over ``torch.distributed`` client
ranks (:mod:`.train`), and the meshes it runs on (:mod:`.mesh`)."""
