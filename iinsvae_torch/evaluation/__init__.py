from iinsvae_torch.evaluation.evaluate import (add_plurality_share, evaluate_joint, evaluate_semi,
                                              export_residuals)

__all__ = ["add_plurality_share", "evaluate_joint", "evaluate_semi", "export_residuals"]
